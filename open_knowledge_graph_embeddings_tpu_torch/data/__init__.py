"""Data layer: vocabulary metadata of mapped-to-ids datasets."""
