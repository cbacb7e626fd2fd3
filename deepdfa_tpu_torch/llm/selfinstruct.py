"""Self-instruct multitask fine-tuning data: the stage that produces the
LoRA adapters the fusion trainer consumes (BASELINE config #4).

A copy of ``deepdfa_tpu/llm/selfinstruct.py`` (host-side numpy, no
framework):

- :func:`multitask_rounds`: the MSIVD multitask dialogue for one function
  (round 1 the verdict, round 2 the CWE type, round 3 an explanation; the
  last two only for a vulnerable example whose dataset provides them);
- :func:`encode_dialogue`: one causal-LM row ``bos, p1, c1, r1, eos, p2,
  r2, eos, ...`` left-padded to ``block_size``, with ``loss_mask`` on the
  response tokens and the eos that ends each response. An over-long
  dialogue shrinks its context (the function body) from the tail first, so
  the instructions and the responses stay whole;
- :func:`encode_multitask` into :class:`LMExamples`, which
  ``LoraFinetuner`` trains on with the response-only loss;
- :class:`FinetunePreset` and :data:`FINETUNE_PRESETS`.

Works with :class:`~deepdfa_tpu_torch.llm.dataset.HashTokenizer`
(``encode_raw``) and with an HF tokenizer (``add_special_tokens=False``).
Its entry point is ``python -m deepdfa_tpu_torch.finetune_llm``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np

__all__ = [
    "DialogueRound",
    "multitask_rounds",
    "encode_dialogue",
    "encode_multitask",
    "LMExamples",
    "FinetunePreset",
    "FINETUNE_PRESETS",
]


@dataclasses.dataclass(frozen=True)
class DialogueRound:
    """``prompt`` is the task instruction — NEVER truncated; ``context`` is
    droppable material (the function body) that shrinks first when the
    dialogue exceeds ``block_size``. Keeping them separate means a long
    function can never silently delete the instruction and change the
    supervised task format."""

    prompt: str
    response: str
    context: str = ""


def multitask_rounds(
    code: str, vul: int, cwe: str = "", explanation: str = ""
) -> list[DialogueRound]:
    """The MSIVD multitask dialogue for one function: detection always;
    type/explanation rounds only when the example is vulnerable AND the
    dataset provides them (DiverseVul: ``cwe`` list + commit ``message``)."""
    rounds = [
        DialogueRound(
            prompt=(
                "Is the following C/C++ function vulnerable? "
                "Answer yes or no.\n"
            ),
            context=code + "\n",
            response="yes" if vul else "no",
        )
    ]
    if vul and cwe:
        rounds.append(
            DialogueRound(
                prompt="What is the vulnerability type of the function?\n",
                response=str(cwe),
            )
        )
    if vul and explanation:
        rounds.append(
            DialogueRound(
                prompt="Explain the vulnerability.\n",
                response=str(explanation),
            )
        )
    return rounds


class LMExamples(NamedTuple):
    """Column-major store for causal-LM tuning with response-masked loss."""

    input_ids: np.ndarray  # [n, block_size] int32
    pad_mask: np.ndarray  # [n, block_size] bool — True = real token
    loss_mask: np.ndarray  # [n, block_size] bool — True = graded token
    indices: np.ndarray  # [n] int64 dataset ids

    def __len__(self) -> int:
        return int(self.input_ids.shape[0])


def _raw_ids(tokenizer, text: str) -> list[int]:
    if hasattr(tokenizer, "encode_raw"):  # HashTokenizer
        return tokenizer.encode_raw(text)
    return list(tokenizer(text, add_special_tokens=False)["input_ids"])


def encode_dialogue(
    tokenizer, rounds: Sequence[DialogueRound], block_size: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One training row: ``bos, p1, c1, r1, eos, p2, r2, eos, ...``
    left-padded to ``block_size``; loss on response+eos tokens only.
    Over-long dialogues shrink CONTEXT segments only (the function body),
    from the tail — the instruction prompts and every response stay whole,
    so truncation can never change the supervised task format (a cut from
    the front would delete the 'Answer yes or no.' instruction of exactly
    the long examples).
    Tail-cut matches the reference's ``truncation=True`` keep-the-head
    behavior (``MSIVD/msivd/train.py:196-208``). If instructions+responses
    alone exceed the block, the degenerate back-truncation applies, keeping
    every earlier answer whole."""
    bos = getattr(tokenizer, "bos_token_id", None)
    eos = tokenizer.eos_token_id
    # (tokens, graded, shrinkable) segments
    segs: list[tuple[list[int], bool, bool]] = []
    if bos is not None:
        segs.append(([bos], False, False))
    for r in rounds:
        segs.append((_raw_ids(tokenizer, r.prompt), False, False))
        if r.context:
            segs.append((_raw_ids(tokenizer, r.context), False, True))
        segs.append((_raw_ids(tokenizer, r.response) + [eos], True, False))
    overflow = sum(len(s[0]) for s in segs) - block_size
    if overflow > 0:
        for i, (toks, graded, shrink) in enumerate(segs):
            if overflow <= 0:
                break
            if shrink:
                cut = min(len(toks), overflow)
                segs[i] = (toks[: len(toks) - cut], graded, shrink)
                overflow -= cut
    ids = [t for toks, _, _ in segs for t in toks]
    loss = [graded for toks, graded, _ in segs for _ in toks]
    if len(ids) > block_size:  # instructions+responses alone exceed the block
        ids, loss = ids[:block_size], loss[:block_size]
    n = len(ids)
    row = np.full(block_size, eos, np.int32)
    pad = np.zeros(block_size, bool)
    lm = np.zeros(block_size, bool)
    row[block_size - n:] = np.asarray(ids, np.int32)
    pad[block_size - n:] = True
    lm[block_size - n:] = np.asarray(loss, bool)
    return row, pad, lm


def encode_multitask(
    codes: Sequence[str],
    vuls: Sequence[int],
    tokenizer,
    block_size: int,
    cwes: Sequence[str] | None = None,
    explanations: Sequence[str] | None = None,
    indices: Sequence[int] | None = None,
) -> LMExamples:
    cwes = cwes if cwes is not None else [""] * len(codes)
    if explanations is None:
        explanations = [""] * len(codes)
    if indices is None:
        indices = np.arange(len(codes))
    rows, pads, lms = [], [], []
    for code, vul, cwe, expl in zip(codes, vuls, cwes, explanations):
        rounds = multitask_rounds(str(code), int(vul), str(cwe or ""),
                                  str(expl or ""))
        r, p, l = encode_dialogue(tokenizer, rounds, block_size)
        rows.append(r)
        pads.append(p)
        lms.append(l)
    z = lambda a, dt: np.stack(a) if a else np.zeros((0, block_size), dt)
    return LMExamples(
        input_ids=z(rows, np.int32),
        pad_mask=z(pads, bool),
        loss_mask=z(lms, bool),
        indices=np.asarray(indices, np.int64),
    )


@dataclasses.dataclass(frozen=True)
class FinetunePreset:
    """A config-#4 launch: dataset + LLM shapes + tuning hypers."""

    name: str
    dataset: str  # ingest.ds name
    llm: str  # "codellama_7b" | "codellama_13b" | "tiny"
    lora_rank: int
    block_size: int
    learning_rate: float
    epochs: int
    batch_size: int


FINETUNE_PRESETS: dict[str, FinetunePreset] = {
    p.name: p
    for p in [
        # the MSIVD stage-1 recipe: DiverseVul multitask explanation tuning
        # producing the adapter checkpoint --finetuned_path consumes
        FinetunePreset(
            name="diversevul_multitask",
            dataset="diversevul",
            llm="codellama_13b",
            lora_rank=16,
            block_size=2048,
            learning_rate=1e-4,
            epochs=1,
            batch_size=4,
        ),
        FinetunePreset(
            name="bigvul_multitask",
            dataset="bigvul",
            llm="codellama_7b",
            lora_rank=16,
            block_size=1024,
            learning_rate=1e-4,
            epochs=1,
            batch_size=4,
        ),
    ]
}
