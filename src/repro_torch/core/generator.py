"""Generation stage (paper §3.3.4): the port of ``ExtractiveLLM`` and
``build_prompt`` from ``repro.core.generator``.

``ExtractiveLLM`` is the deterministic quality oracle: it answers from the
retrieved context with template matching. The model-backed generator
(``ModelLLM``) waits for the model port (ROADMAP.md queue 1).
"""
from __future__ import annotations

import re
from typing import List, Sequence

from repro_torch.core.interfaces import BaseLLM, Chunk
from repro_torch.core.registry import register

PROMPT_TEMPLATE = ("answer the question using the context\n"
                   "context: {context}\nquestion: {question}\nanswer:")


def build_prompt(question: str, contexts: Sequence[Chunk]) -> str:
    ctx = " ".join(c.text for c in contexts)
    return PROMPT_TEMPLATE.format(context=ctx, question=question)


_FACT = re.compile(r"the (\w+) of ([\w\-]+) is ([\w\-]+)")
_Q = re.compile(r"what is the (\w+) of ([\w\-]+)")


@register("llm", "extractive")
class ExtractiveLLM(BaseLLM):
    """Deterministic reader: extracts `the <attr> of <subj> is <val>` facts
    from the retrieved context.  Highest-version chunk wins (freshness)."""

    def generate(self, prompts: Sequence[str],
                 contexts: Sequence[Sequence[Chunk]]) -> List[str]:
        out = []
        for q, ctx in zip(prompts, contexts):
            m = _Q.search(q.lower())
            answer = ""
            if m:
                attr, subj = m.group(1), m.group(2)
                best_ver = -1
                for c in ctx:
                    for fm in _FACT.finditer(c.text.lower()):
                        if fm.group(1) == attr and fm.group(2) == subj \
                                and c.version >= best_ver:
                            best_ver = c.version
                            answer = fm.group(3)
            out.append(answer)
        return out
