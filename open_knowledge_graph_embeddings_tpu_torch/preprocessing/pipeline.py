"""Make-style job DAG for the offline benchmark-creation pipeline.

The port's copy of ``open_knowledge_graph_embeddings_tpu/preprocessing/pipeline.py``.
Capability equivalent of the reference's PipelineJob
(reference: preprocessing/pipeline_job.py:29-98): each job declares the
files it *requires* and *provides*; running a job first recursively runs
whichever registered job provides any missing requirement; a job whose
provided files all exist is skipped (which is also how an interrupted
pipeline resumes).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, Optional, Sequence, Type

logger = logging.getLogger(__name__)


class PipelineJob:
    def __init__(self, requires: Sequence[str], provides: Sequence[str], opts=None, jobs=None):
        self.requires = list(requires)
        self.provides = list(provides)
        self.opts = opts
        self.jobs: Dict[str, "PipelineJob"] = jobs if jobs is not None else {}
        self.jobs[type(self).__name__] = self

    # -- to implement

    def _run(self) -> None:
        raise NotImplementedError

    # -- engine

    def _provider_of(self, path: str) -> Optional["PipelineJob"]:
        for job in self.jobs.values():
            if path in job.provides:
                return job
        return None

    def satisfied(self) -> bool:
        return all(os.path.exists(p) for p in self.provides)

    def run(self) -> None:
        if self.satisfied():
            logger.info("%s: all outputs exist, skipping", type(self).__name__)
            return
        for req in self.requires:
            if os.path.exists(req):
                continue
            provider = self._provider_of(req)
            if provider is None:
                raise FileNotFoundError(
                    f"{type(self).__name__} requires {req} and no registered job provides it"
                )
            provider.run()
            if not os.path.exists(req):
                raise RuntimeError(
                    f"{type(provider).__name__} ran but did not produce {req}"
                )
        for p in self.provides:
            os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
        t0 = time.time()
        logger.info("%s: running", type(self).__name__)
        self._run()
        missing = [p for p in self.provides if not os.path.exists(p)]
        if missing:
            raise RuntimeError(f"{type(self).__name__} finished without producing {missing}")
        logger.info("%s: done in %.1fs", type(self).__name__, time.time() - t0)

    @staticmethod
    def run_jobs(job_classes: Sequence[Type["PipelineJob"]], opts) -> Dict[str, "PipelineJob"]:
        jobs: Dict[str, PipelineJob] = {}
        for cls in job_classes:
            cls(opts=opts, jobs=jobs)
        for job in list(jobs.values()):
            job.run()
        return jobs
