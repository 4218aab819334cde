"""Text quality filtering and deduplication for LM data pipelines.

The port's copy of ``vats_tpu/data/text_cleaning.py`` (pure Python, no
framework): the same regex cleanup (URLs, emails, phone numbers,
non-printables, excess whitespace) in the same order, the ASCII-ratio
English check, the heuristic quality score, exact MD5 dedup, and Jaccard
near-duplicate detection over k-shingles.

Both filters expose the ``datasets.map``-style batched ``__call__``.
"""

from __future__ import annotations

import hashlib
import re
from typing import Dict, List, Optional, Set

_RULES = [
    # (pattern, replacement)
    (re.compile(r"http[s]?://\S+"), " "),
    (re.compile(r"\b[\w.%+-]+@[\w.-]+\.[A-Za-z]{2,}\b"), " "),
    (re.compile(r"\b\d{3}[-.]?\d{3}[-.]?\d{4}\b"), " "),
    (re.compile(r"[^\x20-\x7E\n\t]"), " "),
    (re.compile(r"\s{3,}"), " "),
    (re.compile(r"\n{4,}"), "\n\n"),
    (re.compile(r"[.!?]{4,}"), "..."),
    (re.compile(r" +\n"), "\n"),
    (re.compile(r"\n +"), "\n"),
    (re.compile(r"[“”„]"), '"'),
    (re.compile(r"[‘’]"), "'"),
]

_SENTENCE_RE = re.compile(r"[^.!?]+[.!?]")


class TextQualityFilter:
    """Heuristic quality gate: clean text, score it, drop low-quality rows."""

    def __init__(self, min_length: int = 100, max_length: int = 8192):
        self.min_length = min_length
        self.max_length = max_length
        self.english_ratio_threshold = 0.7

    def is_english(self, text: str) -> bool:
        """ASCII-letter fraction of alphabetic chars >= threshold."""
        alpha = [c for c in text if c.isalpha()]
        if not alpha:
            return False
        ascii_letters = sum(1 for c in alpha if ord(c) < 128)
        return ascii_letters / len(alpha) >= self.english_ratio_threshold

    def clean_text(self, text: str) -> str:
        for pattern, repl in _RULES:
            text = pattern.sub(repl, text)
        return text.strip()

    def calculate_quality_score(self, text: str) -> float:
        """[0, 1] heuristic: a product of penalties, as in the JAX package."""
        if not text:
            return 0.0
        score = 1.0
        n = len(text)
        if n < self.min_length:
            score *= n / self.min_length
        elif n > self.max_length:
            score *= self.max_length / n

        words = text.split()
        if len(words) < 10:
            score *= 0.5
        avg_word = sum(map(len, words)) / max(len(words), 1)
        if not (3 <= avg_word <= 12):
            score *= 0.8
        if len(_SENTENCE_RE.findall(text)) < 3:
            score *= 0.7

        lines = text.split("\n")
        distinct = {ln.strip() for ln in lines if ln.strip()}
        if lines and len(distinct) / len(lines) < 0.8:
            score *= 0.6

        punct = sum(text.count(c) for c in ".,!?;:")
        punct_ratio = punct / max(n, 1)
        if not (0.01 <= punct_ratio <= 0.1):
            score *= 0.8
        caps_ratio = sum(1 for c in text if c.isupper()) / max(n, 1)
        if caps_ratio > 0.2:
            score *= 0.7
        return score

    def filter_text(self, text: str, min_quality: float = 0.5) -> Optional[str]:
        if not text or len(text) < self.min_length:
            return None
        if not self.is_english(text):
            return None
        cleaned = self.clean_text(text)
        if not cleaned or len(cleaned) < self.min_length:
            return None
        if self.calculate_quality_score(cleaned) < min_quality:
            return None
        return cleaned

    def __call__(
        self, batch: Dict[str, List[str]], min_quality: float = 0.5
    ) -> Dict[str, List[Optional[str]]]:
        return {
            "text": [self.filter_text(t, min_quality) for t in batch["text"]]
        }


class DeduplicationFilter:
    """Exact MD5 dedup + optional shingle-based near-dup detection."""

    def __init__(self, similarity_threshold: float = 0.85):
        self.similarity_threshold = similarity_threshold
        self.seen_hashes: Set[str] = set()
        self._shingle_sets: List[Set[str]] = []

    def get_text_hash(self, text: str) -> str:
        canonical = re.sub(r"\s+", " ", text.lower().strip())
        return hashlib.md5(canonical.encode()).hexdigest()

    def get_shingles(self, text: str, k: int = 5) -> Set[str]:
        words = text.lower().split()
        if len(words) < k:
            return {" ".join(words)}
        return {" ".join(words[i : i + k]) for i in range(len(words) - k + 1)}

    def is_duplicate(self, text: str) -> bool:
        """Exact-hash membership; registers unseen texts."""
        h = self.get_text_hash(text)
        if h in self.seen_hashes:
            return True
        self.seen_hashes.add(h)
        return False

    def is_near_duplicate(self, text: str, k: int = 5) -> bool:
        """Jaccard similarity over k-shingles vs previously seen texts.

        O(n) over seen texts: meant for modest corpora or sampled screening."""
        shingles = self.get_shingles(text, k)
        for prior in self._shingle_sets:
            union = len(shingles | prior)
            if union and len(shingles & prior) / union >= self.similarity_threshold:
                return True
        self._shingle_sets.append(shingles)
        return False

    def __call__(
        self, batch: Dict[str, List[Optional[str]]]
    ) -> Dict[str, List[Optional[str]]]:
        return {
            "text": [
                t if (t is not None and not self.is_duplicate(t)) else None
                for t in batch["text"]
            ]
        }
