"""Synthetic multi-modal corpus generators (paper §4.1, Table 3 stand-ins).

No external datasets exist offline; each generator is a deterministic
function of (seed, doc_id) with statistical knobs matched to the dataset it
stands in for (document-length distribution, vocabulary skew, fact density).
Crucially, every document carries *known facts* of the form
``the <attribute> of <subject> is <value>`` so retrieval and answer quality
are exactly gradable — the ground truth the paper obtains from NaturalQuestions
etc. is synthesized here (DESIGN.md §2 assumption 6).

Modalities:
  text  — wiki-style articles (filler sentences + facts);
  code  — function/def-styled documents (github-code stand-in);
  pdf   — section-structured documents with table-like rows (arXiv stand-in);
  audio — transcripts (the ASR-output side of the audio pipeline; the
          conversion stage itself is benchmarked via the encoder model).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

ATTRIBUTES = ["capital", "population", "area", "founder", "currency",
              "altitude", "latitude", "budget", "chairman", "mascot"]

_FILLER = ("alpha beta gamma delta epsilon zeta eta theta iota kappa lambda "
           "mu nu xi omicron pi rho sigma tau upsilon phi chi psi omega").split()


def _rng_for(seed: int, doc_id: int) -> np.random.Generator:
    h = hashlib.blake2b(f"{seed}:{doc_id}".encode(), digest_size=8).digest()
    return np.random.default_rng(int.from_bytes(h, "little"))


def _subject(doc_id: int) -> str:
    return f"entity{doc_id}"


def _value(rng: np.random.Generator) -> str:
    return f"val{rng.integers(0, 10 ** 6)}"


@dataclass
class CorpusConfig:
    n_docs: int = 256
    modality: str = "text"        # text | code | pdf | audio
    sentences_per_doc: int = 20   # mean; actual ~ lognormal around this
    facts_per_doc: int = 4
    seed: int = 0


@dataclass
class Fact:
    doc_id: int
    attribute: str
    value: str

    @property
    def subject(self) -> str:
        return _subject(self.doc_id)

    def sentence(self) -> str:
        return f"the {self.attribute} of {self.subject} is {self.value}."

    def question(self) -> str:
        return f"what is the {self.attribute} of {self.subject}?"


class SyntheticCorpus:
    """Deterministic corpus; documents regenerable by id (stateless restart)."""

    def __init__(self, cfg: CorpusConfig):
        self.cfg = cfg
        self.facts: Dict[int, List[Fact]] = {}
        self.versions: Dict[int, int] = {}
        for d in range(cfg.n_docs):
            self.facts[d] = self._base_facts(d)
            self.versions[d] = 0

    # -- generation ---------------------------------------------------------

    def _base_facts(self, doc_id: int) -> List[Fact]:
        rng = _rng_for(self.cfg.seed, doc_id)
        attrs = rng.choice(ATTRIBUTES, size=self.cfg.facts_per_doc,
                           replace=False)
        return [Fact(doc_id, a, _value(rng)) for a in attrs]

    def _filler_sentence(self, rng: np.random.Generator, doc_id: int) -> str:
        n = int(rng.integers(6, 14))
        words = rng.choice(_FILLER, size=n)
        return f"{_subject(doc_id)} " + " ".join(words) + "."

    def document(self, doc_id: int) -> str:
        """Render the current version of a document."""
        cfg = self.cfg
        rng = _rng_for(cfg.seed + 1000 * self.versions[doc_id], doc_id)
        n_sent = max(int(rng.lognormal(np.log(cfg.sentences_per_doc), 0.4)), 4)
        sents = [self._filler_sentence(rng, doc_id) for _ in range(n_sent)]
        positions = rng.choice(n_sent, size=len(self.facts[doc_id]),
                               replace=False)
        for p, fact in zip(positions, self.facts[doc_id]):
            sents[p] = fact.sentence()
        body = " ".join(sents)
        if cfg.modality == "code":
            lines = [f"def fn_{i}(x): return x  # {s}"
                     for i, s in enumerate(sents)]
            body = "\n".join(lines)
        elif cfg.modality == "pdf":
            body = (f"section 1 introduction. {body} "
                    f"table row {_subject(doc_id)} | "
                    + " | ".join(f.sentence() for f in self.facts[doc_id]))
        elif cfg.modality == "audio":
            body = "um " + body.replace(". ", " uh . ")
        return body

    def all_documents(self) -> List[Tuple[int, str]]:
        return [(d, self.document(d)) for d in range(self.cfg.n_docs)]

    # -- the paper's dynamic ground-truth generation (§3.2, Fig. 3) ---------

    def make_update(self, doc_id: int, rng: np.random.Generator
                    ) -> Tuple[str, str, str]:
        """Modify one fact (the DistilBERT mask-fill role) and synthesize the
        question/answer testing the *new* fact (the T5 QG role).

        Returns (new_document_text, question, ground_truth_answer).
        """
        facts = self.facts[doc_id]
        i = int(rng.integers(0, len(facts)))
        new_value = _value(rng)
        facts[i] = Fact(doc_id, facts[i].attribute, new_value)
        self.versions[doc_id] += 1
        return (self.document(doc_id), facts[i].question(), new_value)

    def question_for(self, doc_id: int, rng: np.random.Generator
                     ) -> Tuple[str, str]:
        """A (question, answer) pair about the document's current facts."""
        facts = self.facts[doc_id]
        f = facts[int(rng.integers(0, len(facts)))]
        return f.question(), f.value

    def new_document(self) -> Tuple[int, str]:
        """Insert op payload: a brand-new document id + text."""
        doc_id = self.cfg.n_docs
        self.cfg.n_docs += 1
        self.facts[doc_id] = self._base_facts(doc_id)
        self.versions[doc_id] = 0
        return doc_id, self.document(doc_id)
