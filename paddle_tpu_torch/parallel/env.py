"""Multi-host environment contract (the port of
``paddle_tpu/parallel/env.py``).

Reference env vars (benchmark/fluid/README.md:36-44): PADDLE_TRAINER_ID,
PADDLE_TRAINER_ENDPOINTS, PADDLE_TRAINERS, PADDLE_TRAINING_ROLE... — kept
verbatim so reference launch scripts work.
"""

import os


def get_trainer_id():
    return int(os.environ.get("PADDLE_TRAINER_ID", "0"))


def get_trainer_endpoints():
    eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
    return [e for e in eps.split(",") if e]


def get_num_trainers():
    eps = get_trainer_endpoints()
    if eps:
        return len(eps)
    return int(os.environ.get("PADDLE_TRAINERS", "1"))


def init_distributed(coordinator_address=None):
    """Bootstrap a multi-process run: False for one endpoint or none, as
    the JAX package returns.  With more endpoints the port would start
    one ``torch.distributed`` process per card, which it does not do yet
    (ROADMAP queue 1, the multi-process mesh), so it raises."""
    eps = get_trainer_endpoints()
    if len(eps) <= 1:
        return False
    raise NotImplementedError(
        f"init_distributed over {len(eps)} endpoints: the port's mesh is "
        "single-controller (one process drives every mesh entry); one "
        "process per card under torch.distributed/NCCL is ROADMAP queue 1's "
        "multi-process mesh item, not ported yet")
