"""Seconds of set-up spent in the program's batch and plan building
(`graph/batch.py`, `graph/dense_batch.py`, `graph/anf_batch.py`,
`ops/segsum.build_*_plans`, `train/loop.plan_batches`, `stack_batches`)
and moving the batches to the card: the driver's `prepare` spans."""


def read(run):
    s = run.rec.seconds("prepare")
    return s if s > 0 else None
