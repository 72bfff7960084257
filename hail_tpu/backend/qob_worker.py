"""Query-on-Batch worker entry point (reference `is/hail/backend/service/
Worker.scala` — a QoB worker process reads a serialized partition function +
context, executes it, and writes the result where the driver will read it).

Invoked by the ServiceBackend as a batch-service job:

    python -m hail_tpu.backend.qob_worker <fn.pkl> <ctx.pkl> <out.pkl>

The worker pins jax to CPU: one JAX process per card, and that process is
the driver — a second process that opened the card would find most of its
memory already reserved. Device-tier compute belongs to the driver (the
reference's split is the same: workers run the region code; BLAS-heavy
lowering happens where the data lands).
"""

from __future__ import annotations

import os
import sys


def main(fn_path: str, ctx_path: str, out_path: str) -> int:
    os.environ.setdefault('JAX_PLATFORM_NAME', 'cpu')
    import jax
    try:
        jax.config.update('jax_platforms', 'cpu')
    except Exception:
        pass

    import cloudpickle

    with open(fn_path, 'rb') as f:
        fn = cloudpickle.load(f)
    with open(ctx_path, 'rb') as f:
        ctx = cloudpickle.load(f)

    result = fn(ctx)

    tmp = out_path + '.tmp'
    with open(tmp, 'wb') as f:
        cloudpickle.dump(result, f)
    os.replace(tmp, out_path)   # atomic: a partial write never looks complete
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1], sys.argv[2], sys.argv[3]))
