"""The yardstick's counts start out consistent with the port's kernel
table: each kernel function reproduces the bound column of PERF.md
section 6 (ms, at the published H100 clock) at the shapes listed there."""

import pytest

from kzgbench import roofline as R

TABLE = [
    ("K1 stage 2's beta products [811008]", lambda: R.fp_mont_mul_by_const(811008), 0.0291, "operations"),
    ("K2 a chunk's terms [262144, 8]", lambda: R.fr_mont_mul(262144), 0.0075, "bytes"),
    ("K2 full width [16777216, 8]", lambda: R.fr_mont_mul(16777216), 0.4808, "bytes"),
    ("K2 Fermat chain r - 2 at [4096]", lambda: R.fr_inverse(4096), 0.0182, "operations"),
    ("K3 [540672]", lambda: R.proj_add(540672), 0.2327, "operations"),
    ("K3 [65536]", lambda: R.proj_add(65536), 0.0282, "operations"),
    ("K4 chain [8192]", lambda: R.double_chain(8192), 0.3080, "operations"),
    ("K4 chain [128]", lambda: R.double_chain(128), 0.0048, "operations"),
    ("K5 A [8192]", lambda: R.decompress(8192), 0.1114, "operations"),
    ("K5 B [8192]", lambda: R.subgroup_check(8192), 0.0579, "operations"),
    ("M1 [4096]", lambda: R.glv_digits(4096), 0.00010, "bytes"),
    ("kzg_fr_ingest a chunk [64, 4096]", lambda: R.fr_ingest(64 * 4096), 0.0050, "bytes"),
    ("kzg_fr_sum_rows [4096, 64]", lambda: R.fr_sum_rows(4096, 64), 0.0025, "bytes"),
]


@pytest.mark.parametrize("name,work,bound_ms,by", TABLE, ids=[t[0] for t in TABLE])
def test_kernel_bound_matches_the_kernel_table(name, work, bound_ms, by):
    w = work()
    assert R.bound_s(w) * 1e3 == pytest.approx(bound_ms, rel=0.02, abs=6e-6)
    assert R.bound_by(w) == by


def test_stage_counts_grow_with_real_lanes_only():
    for stage in (R.verify_stage1, lambda n: R.verify_bary(n, 4096)):
        assert stage(1152).ops == pytest.approx(1152 * stage(1).ops)
    assert R.verify_call(1152, 4096, stage2=False).ops < R.verify_call(1152, 4096).ops
    assert R.bound_s(R.prove_commit(4096)) < R.bound_s(R.prove_proof(4096))
