"""YAML config with CLI overrides."""
