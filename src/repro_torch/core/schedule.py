"""Five-core pipelined schedule model (paper Fig. 5; the reference's
src/repro/core/schedule.py, copied: pure Python, no tensor).

The optical block has 5 cores (C1..C5). With the Eq. 2 decomposition, the
attention step for one input needs these MatMuls:

    C1: Q      = X @ W_Q             (tunable at t0: W_Q)
    C2: QWk    = Q @ (W_K^T/sqrt dk) (tunable at t0: W_K^T)
    C3: S      = QWk @ X^T           (tunable at t0: X^T)
    -- softmax in the EPU --
    C4: A      = softmax(S) @ ...    (tuned while C1-C3 compute)
    C5: out    = A @ W_V ...         (tuned while C1-C3 compute)

Without the decomposition, computing S = Q K^T requires K to exist before a
core can be tuned with K^T: one extra serialized tuning + a K buffer.

This module provides a small event-driven occupancy simulator for both
schedules so benchmarks can report the pipeline utilization / latency delta
attributable to the decomposition (the paper's Fig. 5 argument), without
pretending to cycle accuracy. It is a model of the optical block's cores,
not a learning-rate schedule (that is ``optim/adamw.py::warmup_cosine``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["CoreTask", "simulate_pipeline", "attention_schedule"]


@dataclass
class CoreTask:
    name: str
    core: int                 # 0..n_cores-1
    compute_us: float         # optical compute duration
    tuning_us: float          # MR tuning before compute can start
    deps: tuple[str, ...] = ()  # task names that must finish first
    # tuning can begin once `tune_deps` are done (operand availability);
    # by default tuning needs no deps (operand known at t0) — that is the
    # decomposition's win.
    tune_deps: tuple[str, ...] = ()


def simulate_pipeline(tasks: list[CoreTask], n_cores: int = 5,
                      epu_tasks: dict[str, tuple[float, tuple[str, ...]]] | None = None):
    """Greedy list-scheduler over cores; returns (makespan_us, timeline).

    epu_tasks: name -> (duration_us, deps) executed on the electronic unit
    (assumed unlimited parallelism vs the 5 scarce optical cores).
    """
    epu_tasks = epu_tasks or {}
    finish: dict[str, float] = {}
    core_free = [0.0] * n_cores
    timeline = []
    pending = list(tasks)
    epu_pending = dict(epu_tasks)

    def ready(deps):
        return all(d in finish for d in deps)

    progress = True
    while (pending or epu_pending) and progress:
        progress = False
        for name, (dur, deps) in list(epu_pending.items()):
            if ready(deps):
                start = max((finish[d] for d in deps), default=0.0)
                finish[name] = start + dur
                timeline.append((name, "EPU", start, finish[name]))
                del epu_pending[name]
                progress = True
        for t in list(pending):
            if ready(t.deps) and ready(t.tune_deps):
                tune_start = max([core_free[t.core]] +
                                 [finish[d] for d in t.tune_deps])
                compute_start = max([tune_start + t.tuning_us] +
                                    [finish[d] for d in t.deps])
                finish[t.name] = compute_start + t.compute_us
                core_free[t.core] = finish[t.name]
                timeline.append((t.name, f"C{t.core + 1}", tune_start, finish[t.name]))
                pending.remove(t)
                progress = True
    if pending or epu_pending:
        raise ValueError(f"deadlock: unresolved {pending} / {epu_pending}")
    return max(finish.values()), sorted(timeline, key=lambda r: r[2])


def attention_schedule(compute_us: float, tuning_us: float, softmax_us: float,
                       decomposed: bool = True):
    """Build the Fig. 5 attention-head task graph for one input.

    Returns (makespan, timeline). ``decomposed=False`` models the naive
    Q.K^T flow where the score core's tuning must wait for K (tune_deps).
    """
    if decomposed:
        tasks = [
            CoreTask("Q", 0, compute_us, tuning_us),
            CoreTask("QWk", 1, compute_us, tuning_us, deps=("Q",)),
            CoreTask("S", 2, compute_us, tuning_us, deps=("QWk",)),
            CoreTask("AV", 3, compute_us, tuning_us, deps=("softmax",),
                     tune_deps=()),          # W_V tunable at t0
            CoreTask("proj", 4, compute_us, tuning_us, deps=("AV",)),
        ]
    else:
        tasks = [
            CoreTask("Q", 0, compute_us, tuning_us),
            CoreTask("K", 1, compute_us, tuning_us),
            # K^T must be tuned AFTER K exists -> serialized tuning bubble.
            CoreTask("S", 2, compute_us, tuning_us, deps=("Q",),
                     tune_deps=("K",)),
            CoreTask("AV", 3, compute_us, tuning_us, deps=("softmax",)),
            CoreTask("proj", 4, compute_us, tuning_us, deps=("AV",)),
        ]
    epu = {"softmax": (softmax_us, ("S",))}
    return simulate_pipeline(tasks, n_cores=5, epu_tasks=epu)
