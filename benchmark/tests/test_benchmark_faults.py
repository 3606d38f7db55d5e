"""A run with the timed path broken underneath: ``correct`` has to come out
false, once for each fault a cell can have (for training, the cached
negatives too: read from another batch's slot, or altered where they are
made). The cells run on one card, so there is no exchange between cards to
leave out. The harness's look for a card is skipped; everything else of a
run is driven, on the tiny cells of ``benchmark_tiny``."""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import benchmark_tiny  # noqa: E402

UNCHANGED = """
from control import FAULTS
program = FAULTS["unchanged"]
"""

HALF_BATCH = """
from control import FAULTS
program = FAULTS["half_batch"]
"""

WRONG_SLOT = """
from control import FAULTS
program = FAULTS["wrong_slot"]
"""

ALTERED_NEGATIVES = """
from control import FAULTS
program = FAULTS["altered_negatives"]
"""

ANSWER_ALTERED = '''
def program(encoder, index):
    def search(emb, k):
        s, i = index.search(emb, k)
        i = i.copy()
        i[:, 0] = (i[:, 0] + 1) % len(index)
        return s, i
    return encoder.extract_features, search
'''

HALF_QUERIES = '''
import numpy as np
def program(encoder, index):
    def embed(images):
        half = images[: max(1, len(images) // 2)]
        e = encoder.extract_features(half)
        return np.concatenate([e, e])[: len(images)]
    return embed, index.search
'''


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return benchmark_tiny.make_copy(str(tmp_path_factory.mktemp("bench")))


def _correct(root, workload, fault):
    code = fault + f"""
import json, run
args = run._args(["--workload", {workload!r}, "--seed", "11",
                  "--seconds", "1", "--trace", "0"])
code, (rec, result) = run.run_cell(args, device="cpu", program=program)
print(json.dumps(result))
"""
    proc = benchmark_tiny.run_python(root, code)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return benchmark_tiny.result_line(proc.stdout)


@pytest.mark.parametrize("workload,fault,caught_by", [
    ("tiny-train", UNCHANGED, "delta"),
    ("tiny-train", HALF_BATCH, "loss1"),
    ("tiny-train", WRONG_SLOT, "mined_loss1"),
    ("tiny-train", ALTERED_NEGATIVES, "mine"),
    ("tiny-retrieve", ANSWER_ALTERED, "topk"),
    ("tiny-retrieve", HALF_QUERIES, "embed"),
], ids=["state-unchanged", "half-batch", "negatives-of-another-batch",
        "negatives-altered", "answer-altered", "half-queries"])
def test_a_broken_timed_path_is_not_correct(tiny, workload, fault,
                                            caught_by):
    res = _correct(tiny, workload, fault)
    assert res["correct"] is False, res["checks"]
    c = res["checks"][caught_by]
    assert c["value"] > c["limit"], res["checks"]
