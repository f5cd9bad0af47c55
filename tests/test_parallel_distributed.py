"""Multi-host program-shape validation on a single-process virtual 2x4 mesh
(BASELINE config 5: blobs sharded across N>=2 hosts; conftest forces 8 CPU
devices).  The (host, chip) PartitionSpecs compiled here are exactly what a
real pod runs; only the physical transport differs (DCN/ICI vs host RAM).
"""

from __future__ import annotations

import random

import jax
import pytest

from kzg_rust_tpu.golden import curve as gc
from kzg_rust_tpu.golden.field import R
from kzg_rust_tpu.parallel import distributed as D

rng = random.Random(0xD157)


def test_initialize_distributed_entry_exists():
    """The documented multi-host entry point delegates to
    jax.distributed.initialize (smoke: wiring only, no cluster here)."""
    assert callable(D.initialize_distributed)
    with pytest.raises(Exception):
        # No coordinator in the test environment: the call must reach
        # jax.distributed (and fail there), not silently no-op.
        D.initialize_distributed("localhost:1", num_processes=2, process_id=5)


@pytest.mark.slow
def test_batch_stages_on_2x4_host_chip_mesh():
    import jax.numpy as jnp
    import numpy as np

    from kzg_rust_tpu.ops import curve as C
    from kzg_rust_tpu.ops import msm as M
    from kzg_rust_tpu.ops import verify_kernels as V

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = D.host_chip_mesh(2, 4)
    assert mesh.axis_names == (D.HOST_AXIS, D.CHIP_AXIS)
    n = 8  # one blob per device

    commitments = [gc.g1_mul(gc.G1_GENERATOR, rng.randrange(1, R)) for _ in range(n)]
    proofs = [gc.g1_mul(gc.G1_GENERATOR, rng.randrange(1, R)) for _ in range(n)]
    comp_rows = []
    for i in range(n):
        comp_rows.append(gc.g1_compress(commitments[i]))
        comp_rows.append(gc.g1_compress(proofs[i]))
    comp = np.frombuffer(b"".join(comp_rows), dtype=np.uint8).reshape(2 * n, 48)
    bases, bases2, flags = D.batch_points_kernel_2axis(jnp.asarray(comp), mesh)
    assert bool(np.asarray(flags)[0]) and bool(np.asarray(flags)[1])

    r_powers = [rng.randrange(R) for _ in range(n)]
    r_times_z = [rng.randrange(R) for _ in range(n)]
    ys = [rng.randrange(R) for _ in range(n)]
    ry = sum(rp * y for rp, y in zip(r_powers, ys)) % R
    out = D.batch_stage2_kernel_2axis(
        bases,
        bases2,
        jnp.asarray(V.stage2_digits(n, r_powers, r_times_z)),
        V.build_generator_table(),
        jnp.asarray(M.recode_signed_digits([ry], 1), dtype=jnp.int32),
        mesh,
    )
    lhs, rhs = C.proj_to_points(np.asarray(out))

    assert lhs == gc.g1_lincomb_naive(proofs, r_powers)
    cmy = [
        gc.g1_sub(commitments[i], gc.g1_mul(gc.G1_GENERATOR, ys[i])) for i in range(n)
    ]
    assert rhs == gc.g1_add(
        gc.g1_lincomb_naive(cmy, r_powers), gc.g1_lincomb_naive(proofs, r_times_z)
    )


@pytest.mark.slow
def test_two_process_distributed_smoke():
    """TRUE multi-process validation: two OS processes join through
    ``initialize_distributed`` (gloo CPU collectives), psum over the global
    (host, chip) mesh, and run the REAL sharded verification kernels
    (stage 1 + stage 2 + domain-sharded barycentric) against golden — the
    program shape of BASELINE config 5 with real cross-process
    communication (tools/multiproc_smoke.py)."""
    import pathlib
    import subprocess
    import sys

    script = pathlib.Path(__file__).resolve().parent.parent / "tools" / "multiproc_smoke.py"
    # Cold XLA-CPU compiles of the stage kernels inside BOTH children can
    # take several minutes (warm runs hit the persistent cache), and suite
    # workers compete for cores; the deadline covers the cold case.
    proc = subprocess.run(
        [sys.executable, str(script)],
        capture_output=True,
        timeout=1800,
        text=True,
    )
    out = proc.stdout + proc.stderr
    if "gloo" in out.lower() and proc.returncode != 0 and "MULTIPROC OK" not in out:
        if "Unrecognized config option" in out or "collectives" in out.lower():
            pytest.skip("jax build lacks CPU gloo collectives")
    assert proc.returncode == 0 and "MULTIPROC OK" in out, out[-2000:]


@pytest.mark.slow
def test_msm_2axis_on_2x4_host_chip_mesh():
    """2-axis (host, chip) point-sharded fixed-base MSM vs the golden naive
    lincomb (VERDICT round-3 item 7): the prover's point axis on a real pod
    shards over host x chip with the partial-sum all_gather running
    chip-axis (ICI) first."""
    rng = random.Random(0x2A815)
    mesh = D.host_chip_mesh(2, 4)
    n = 16  # 2 points per device on the 2x4 mesh
    pts = [gc.g1_mul(gc.G1_GENERATOR, rng.randrange(1, R)) for _ in range(n)]
    # Include an infinity point and a zero scalar: the masked-gather edge
    # cases must survive the 2-axis sharding too.
    pts[3] = None
    scalars = [rng.randrange(R) for _ in range(n)]
    scalars[5] = 0
    ctx = D.ShardedMsmContext2Axis.build_from_points(pts, mesh, fold=16)
    got = D.msm_fixed_base_2axis(ctx, scalars)
    assert got == gc.g1_lincomb_naive(pts, scalars)
