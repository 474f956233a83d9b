"""A cell found by name: its workload, configuration and traffic files."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

from portbench.reference import JobShape

HERE = Path(__file__).resolve().parent


def load(kind: str, name: str) -> dict:
    """``portbench/<kind>/<name>.json``."""
    path = HERE / kind / f"{name}.json"
    try:
        return json.loads(path.read_text())
    except FileNotFoundError:
        raise SystemExit(f"portbench: no {kind[:-1]} named {name!r} ({path})") from None


@dataclasses.dataclass(frozen=True)
class Job:
    """One job of a traffic mix: its configuration's job with the mix's
    settings over it."""

    mappers: int
    reducers: int
    workers: int
    combiner: bool
    capacity_factor: float
    setup_rounds: int
    setup_dim: int
    reduce_backend: str
    shuffle_backend: str

    def job_config(self):
        from repro_torch.mapreduce import JobConfig

        return JobConfig(
            num_mappers=self.mappers, num_reducers=self.reducers,
            num_workers=self.workers, combiner=self.combiner,
            capacity_factor=self.capacity_factor,
            setup_rounds=self.setup_rounds, setup_dim=self.setup_dim,
            reduce_backend=self.reduce_backend,
            shuffle_backend=self.shuffle_backend,
        )


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int

    def jobs(self) -> list[Job]:
        """The jobs the window cycles through, in order."""
        base = {**self.config["job"], **self.traffic.get("common", {})}
        return [Job(**{**base, **entry}) for entry in self.traffic["jobs"]]

    def key_space(self, tokens: int) -> int:
        from portbench import gen

        return gen.key_space(self.config, tokens)

    def app(self, tokens: int):
        """The program's application object for a corpus of ``tokens``."""
        from repro_torch.mapreduce import eximparse, wordcount

        if self.config["app"] == "wordcount":
            return wordcount(self.key_space(tokens))
        return eximparse(self.key_space(tokens))

    def shape(self, job: Job, tokens: int) -> JobShape:
        if job.shuffle_backend != "lexsort":
            raise ValueError("the reference follows the lexsort shuffle only")
        return JobShape(
            app=self.config["app"], tokens=tokens, mappers=job.mappers,
            reducers=job.reducers, combiner=job.combiner,
            capacity_factor=job.capacity_factor, key_space=self.key_space(tokens),
        )


def load_cell(name: str) -> Cell:
    w = load("workloads", name)
    return Cell(name=name, config=load("configs", w["config"]),
                traffic=load("traffic", w["traffic"]), chips=int(w["chips"]))
