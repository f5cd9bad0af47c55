"""The control (the reference with one guarantee broken, in the
program's place) comes out not correct under the run's own comparison, at
a size a test run holds: the verifier without its subgroup check on calls
that include off-subgroup faults, and the prover whose challenge leaves
the commitment out."""

from kzgbench import control


def test_verifier_without_the_subgroup_check_is_not_correct(minimal_root):
    root = minimal_root({"fault_every": 1, "fault_kinds": ["off_subgroup"]})
    out = control.control_run("min.verify", 3_000_000_005, 3, root=root, reference_workers=2)
    assert out["correct"] is False
    assert out["checks"]["reference_mismatches"]["value"] == 3


def test_prover_with_an_unbound_challenge_is_not_correct(minimal_root):
    root = minimal_root()
    out = control.control_run("min.tx", 3_000_000_006, 2, root=root, reference_workers=2)
    assert out["correct"] is False
    assert out["checks"]["reference_mismatches"]["value"] == 4
    assert out["checks"]["verify_rejected_batches"]["value"] == 2
