"""Whether a run is ``correct``: the numbers compared, each with its limit.

Verification: every call's verdict or error kind against what its inputs
give by construction, and a sample of calls (every faulty one and some
valid ones, drawn from the seed) against the reference's answer, worked out
again from the same inputs in the reference's processes.  A call that ends
in an exception the specs do not raise counts as crashed.  The prover: a
sample of blobs drawn from the seed, their commitment and proof bytes
against the reference's; and a larger sample, drawn apart, whose (blob,
commitment, proof) triples the reference's batch verification must accept,
in batches.  Every comparison is exact, so every limit is 0.
"""

from __future__ import annotations

# The program's errors by the kind of input the specs refuse, from the
# words of their messages (the error type is the specs' one, KzgError).
_KINDS = (("subgroup", "not_in_subgroup"), ("bytes32", "non_canonical"), ("bls_field", "non_canonical"), ("length", "bad_length"), ("g1", "invalid_g1"))


def error_kind(message: str) -> str:
    low = message.lower()
    for word, kind in _KINDS:
        if word in low:
            return kind
    return f"unknown: {message}"


def verify_numbers(calls: list, sample: list[int], answers: list) -> dict:
    """calls: the window's calls with their ``outcome``; sample: indices
    of the calls the reference answered, in the order of ``answers``."""
    return {
        "crashed_calls": (sum(1 for c in calls if isinstance(c.outcome, str) and c.outcome.startswith("crash")), 0),
        "construction_mismatches": (sum(1 for c in calls if c.outcome != c.expect), 0),
        "reference_mismatches": (sum(1 for k, a in zip(sample, answers) if calls[k].outcome != a), 0),
        "reference_calls_unchecked": (0 if sample else 1, 0),
    }


def output(calls: list, k: int, j: int):
    """Call k's (commitment, proof) of its blob j, None where it made none."""
    return calls[k].outputs[j] if k < len(calls) and j < len(calls[k].outputs) else None


def prove_numbers(calls: list, sample: list[tuple[int, int]], answers: list, verified: list[list[tuple[int, int]]], verdicts: list) -> dict:
    """sample: (call, blob) pairs the reference proved, in the order of
    ``answers`` ((commitment, proof) each); verified: batches of (call,
    blob) pairs whose outputs the reference verified, in the order of
    ``verdicts`` (True where the batch holds)."""
    return {
        "crashed_calls": (sum(1 for c in calls if isinstance(c.outcome, str) and c.outcome.startswith("crash")), 0),
        "reference_mismatches": (sum(1 for (k, j), a in zip(sample, answers) if output(calls, k, j) != a), 0),
        "reference_blobs_unchecked": (0 if sample else 1, 0),
        "verify_rejected_batches": (sum(1 for v in verdicts if v is not True), 0),
        "verify_batches_unchecked": (0 if verified else 1, 0),
    }


def passed(numbers: dict) -> bool:
    return all(value <= limit for value, limit in numbers.values())
