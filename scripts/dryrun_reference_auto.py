"""The reference's multi-pod dry run (``repro.launch.dryrun``) on mesh axes
of type ``Auto``, as the reference was written for.

Under jax 0.9.0 ``jax.make_mesh`` makes ``Explicit`` axes, on which a
``with_sharding_constraint`` is an assertion, and the reference's
production cells fail at their first constraint. Its comments (and
``repro.models.shard_ctx``) treat a constraint as a hint to GSPMD, which is
what ``Auto`` axes give. This script wraps ``jax.make_mesh`` to pass
``axis_types=(AxisType.Auto,) * n`` and then runs the reference's own CLI
unchanged, with its flags, into ``results/dryrun_ref_auto/`` unless
``--out`` says otherwise. It imports the reference; the port and
``chip_smoke.py`` never do. Its cells are the reference plans that
``PERF.md`` §6 sets beside the port's (``python -m
repro_torch.launch.dryrun``).

    PYTHONPATH=src python scripts/dryrun_reference_auto.py \\
        --arch dbrx_132b --shape prefill_32k --both-meshes
"""
import sys

import repro.launch.dryrun as dryrun   # sets the 512 host devices first
import jax                             # noqa: E402
from jax.sharding import AxisType      # noqa: E402

_make_mesh = jax.make_mesh


def make_auto_mesh(shape, names, **kw):
    """``jax.make_mesh`` with every axis ``Auto`` unless the caller asks."""
    kw.setdefault("axis_types", (AxisType.Auto,) * len(shape))
    return _make_mesh(shape, names, **kw)


def main() -> None:
    jax.make_mesh = make_auto_mesh
    if "--out" not in sys.argv:
        sys.argv += ["--out", "results/dryrun_ref_auto"]
    dryrun.main()


if __name__ == "__main__":
    main()
