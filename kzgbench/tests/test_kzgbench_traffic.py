"""The generator: the same seed gives the same calls, another seed other
calls; one call in ``fault_every`` is faulty, the kinds in turn; every
lane is a bytes object of its own; the ring holds its multiple of the
last-level cache."""


import pytest

from kzgbench import generator

BLOB = 32 * 4
POOL = [(bytes([i]) * BLOB, bytes([0x80 | i]) + bytes(47), bytes([0xA0 | i]) + bytes(47)) for i in range(6)]
CONFIG = {"FIELD_ELEMENTS_PER_BLOB": 4}


def verify_mix(**kw):
    mix = {
        "api": "verify_blob_kzg_proof_batch", "blobs_per_call": 8, "fault_every": 16,
        "fault_kinds": list(generator.FAULT_KINDS), "pool_size": 6, "pool_seed": 1,
        "ring_llc_multiple": 4, "prebuilt_calls": 0,
    }
    mix.update(kw)
    return mix


def calls(seed, n=160, mix=None, llc=1 << 14):
    t = generator.traffic(mix or verify_mix(), CONFIG, seed, POOL, llc)
    return t, [t.call(k) for k in range(n)]


def digest(cs):
    return [(c.args, c.expect, c.fault and (c.fault["kind"], c.fault["lane"], c.fault["field"])) for c in cs]


@pytest.mark.parametrize("seed", [0, 3_000_000_017, 2**33 + 5])
def test_same_seed_same_calls(seed):
    assert digest(calls(seed)[1]) == digest(calls(seed)[1])


def test_other_seed_other_calls():
    a, b = digest(calls(11)[1]), digest(calls(12)[1])
    assert [x[0] for x in a] != [x[0] for x in b]
    assert [x[2] for x in a] != [x[2] for x in b]


def test_one_call_in_sixteen_is_faulty_and_the_kinds_take_turns():
    t, cs = calls(5)
    faulty = [k for k, c in enumerate(cs) if c.fault is not None]
    assert len(faulty) == 10 and all((b - a) == 16 for a, b in zip(faulty, faulty[1:]))
    kinds = [cs[k].fault["kind"] for k in faulty]
    assert set(kinds[:5]) == set(generator.FAULT_KINDS) and kinds[:5] == kinds[5:]
    for k in faulty:
        f = cs[k].fault
        col = {"blob": 0, "commitment": 1, "proof": 2}[f["field"]]
        assert cs[k].args[col][f["lane"]] == f["bytes"] != POOL[cs[k].lanes[f["lane"]]][col]
        assert cs[k].expect == generator.EXPECT[f["kind"]]


def test_fault_phase_follows_the_seed():
    phases = {next(k for k, c in enumerate(calls(s, 32)[1]) if c.fault) for s in range(12)}
    assert len(phases) > 3


def test_lanes_are_objects_of_their_own_and_the_ring_spans_its_cache_multiple():
    llc = 1 << 14
    t, cs = calls(7, n=4, llc=llc)
    assert t.ring_bytes >= 4 * llc
    ids = [id(b) for c in cs[:2] for col in c.args for b in col]
    assert len(set(ids)) == len(ids)
    assert all(id(b) != id(p[0]) for p in POOL for b in cs[0].args[0])


def test_poster_blobs_are_canonical_and_seeded():
    mix = {"api": "blob_tx", "blobs_per_call": 6, "ring_llc_multiple": 4}
    a = generator.traffic(mix, CONFIG, 9, None, 1 << 12)
    b = generator.traffic(mix, CONFIG, 9, None, 1 << 12)
    c = generator.traffic(mix, CONFIG, 10, None, 1 << 12)
    assert a.call(3).args == b.call(3).args != c.call(3).args
    blob = a.call(0).args[0][0]
    assert len(blob) == BLOB and all(blob[i] == 0 for i in range(0, BLOB, 32))
    assert a.ring_bytes >= 4 * (1 << 12)


def test_last_level_cache_is_read():
    assert generator.last_level_cache_bytes() > 0
