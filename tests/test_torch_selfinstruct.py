"""The port's self-instruct data (``deepdfa_tpu_torch.llm.selfinstruct``)
and ``devign_split`` against the JAX package's, on the CPU: ids, pad masks
and loss masks element for element on the demo corpus, over-long
dialogues, a tokenizer without a bos id; the presets field for field.
"""

import dataclasses

import numpy as np
import pytest

from deepdfa_tpu.llm import dataset as jds
from deepdfa_tpu.llm import selfinstruct as jsi

from deepdfa_tpu_torch.finetune_llm import demo_rows
from deepdfa_tpu_torch.llm import dataset as tds
from deepdfa_tpu_torch.llm import selfinstruct as tsi


def _columns(rows):
    return ([r["before"] for r in rows], [r["vul"] for r in rows],
            [r["cwe"] for r in rows], [r["message"] for r in rows],
            [r["id"] for r in rows])


@pytest.mark.parametrize("block", [32, 128, 512])
def test_encode_multitask_is_the_jax_encoding(block):
    codes, vuls, cwes, msgs, ids = _columns(demo_rows(24, seed=3))
    want = jsi.encode_multitask(codes, vuls, jds.HashTokenizer(2048), block,
                                cwes=cwes, explanations=msgs, indices=ids)
    got = tsi.encode_multitask(codes, vuls, tds.HashTokenizer(2048), block,
                               cwes=cwes, explanations=msgs, indices=ids)
    assert len(got) == len(want) == 24
    for field in tsi.LMExamples._fields:
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert got.loss_mask.any() and (got.loss_mask <= got.pad_mask).all()


class _NoBos:
    """A tokenizer without a bos id, called like an HF one."""

    eos_token_id = 0

    def __call__(self, text, add_special_tokens=False):
        return {"input_ids": [3 + (ord(c) % 50) for c in text]}


@pytest.mark.parametrize("block", [16, 40, 400])
def test_encode_dialogue_is_the_jax_encoding(block):
    """An over-long dialogue shrinks its context first, then (instructions
    and responses alone too long) cuts from the back; a short one pads."""
    rounds = [("Is it vulnerable?\n", "int f() { return buf[9]; }\n", "yes"),
              ("Which CWE?\n", "", "CWE-787"),
              ("Explain.\n", "", "writes past the end of buf")]
    for tok_j, tok_t in ((jds.HashTokenizer(320), tds.HashTokenizer(320)),
                         (_NoBos(), _NoBos())):
        want = jsi.encode_dialogue(
            tok_j, [jsi.DialogueRound(p, r, c) for p, c, r in rounds], block)
        got = tsi.encode_dialogue(
            tok_t, [tsi.DialogueRound(p, r, c) for p, c, r in rounds], block)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_multitask_rounds_and_presets_are_the_jax_ones():
    for args in (("int f();", 1, "CWE-787", "why"), ("int f();", 0, "x", "y"),
                 ("int f();", 1, "", "")):
        assert [dataclasses.asdict(r) for r in tsi.multitask_rounds(*args)] \
            == [dataclasses.asdict(r) for r in jsi.multitask_rounds(*args)]
    assert {k: dataclasses.asdict(v) for k, v in
            tsi.FINETUNE_PRESETS.items()} == {
        k: dataclasses.asdict(v) for k, v in jsi.FINETUNE_PRESETS.items()}
    empty = tsi.encode_multitask([], [], tds.HashTokenizer(), 8)
    assert empty.input_ids.shape == (0, 8) and len(empty) == 0


@pytest.mark.parametrize("n", [0, 1, 7, 10, 101])
def test_devign_split_is_the_jax_split(n):
    got, want = tds.devign_split(n), jds.devign_split(n)
    assert list(got) == list(want) == ["train", "eval", "test"]
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    assert sum(len(v) for v in got.values()) == n
