"""The c-kzg-4844 test vectors under ``tests/`` of the repository, read
without a YAML library (their layout is fixed), and run through the
benchmark's plain reference."""

import glob
import os
import re

from kzgbench.reference import kzg

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def read_vector(path: str):
    """(input fields, expected output) of one ``data.yaml``: strings and
    lists of strings; the output a bool, a hex string, a list of them, or
    None for an input the function must refuse."""
    with open(path) as fh:
        text = fh.read()
    inp, out = text.split("\noutput:")
    fields = {}
    for m in re.finditer(r"(\w+):\s*(\[[^\]]*\]|'[^']*')", inp):
        strs = re.findall(r"'([^']*)'", m.group(2))
        fields[m.group(1)] = strs if m.group(2).startswith("[") else strs[0]
    for m in re.finditer(r"(?m)^[ \t]+(\w+):[ \t]*\n((?:[ \t]+- '[^']*'[ \t]*(?:\n|$))+)", inp):
        fields[m.group(1)] = re.findall(r"'([^']*)'", m.group(2))
    out = out.strip()
    strs = re.findall(r"'([^']*)'", out)
    if out.startswith(("[", "-")):
        return fields, strs
    return fields, strs[0] if strs else {"true": True, "false": False, "null": None}[out]


def cases(suite: str, kind: str) -> list[str]:
    return sorted(glob.glob(os.path.join(REPO, "tests", suite, kind, "*", "*", "data.yaml")))


def h(s: str) -> bytes:
    return bytes.fromhex(s[2:] if s.startswith("0x") else s)


def run(setup: kzg.Setup, kind: str, fields: dict):
    """The reference's output for one vector: bytes are given as 0x-hex,
    a refused input as None."""
    try:
        if kind == "blob_to_kzg_commitment":
            return "0x" + kzg.blob_to_kzg_commitment(setup, h(fields["blob"])).hex()
        if kind == "compute_blob_kzg_proof":
            return "0x" + kzg.compute_blob_kzg_proof(setup, h(fields["blob"]), h(fields["commitment"])).hex()
        if kind == "compute_kzg_proof":
            proof, y = kzg.compute_kzg_proof(setup, h(fields["blob"]), h(fields["z"]))
            return ["0x" + proof.hex(), "0x" + y.hex()]
        if kind == "verify_kzg_proof":
            return kzg.verify_kzg_proof(setup, *(h(fields[k]) for k in ("commitment", "z", "y", "proof")))
        if kind == "verify_blob_kzg_proof":
            return kzg.verify_blob_kzg_proof(setup, *(h(fields[k]) for k in ("blob", "commitment", "proof")))
        if kind == "verify_blob_kzg_proof_batch":
            return kzg.verify_blob_kzg_proof_batch(setup, *([h(x) for x in fields[k]] for k in ("blobs", "commitments", "proofs")))
    except kzg.RefError:
        return None
    raise ValueError(kind)
