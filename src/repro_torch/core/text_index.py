"""Inverted text index: CSR postings + impact scores
(port of ``repro/core/text_index.py``, docid layout, uncompressed store).

* ``postings i32[P]`` — doc ids, ascending within each term's slice.
* ``impacts f32[P]`` — each posting's full lnc.ltc contribution
  ``ln(1 + n/f_t) · (1 + ln f_{D,t}) / sqrt(|D|)``.
* ``offsets i32[M+1]`` — term w owns ``postings[offsets[w]:offsets[w+1]]``.
* logical 128-posting blocks (``blk_term_off/blk_pos/blk_len``) with their
  ``blk_max_impact`` — the pruned TEXT-FIRST's skip unit, built here so the
  index equals the reference's field for field.
* optional u32 block bitmaps for the most frequent terms.

The packed PForDelta store and the impact-ordered layout are not ported
yet: their columns keep the reference's uncompressed/docid shapes
(zero-width packed columns, one degenerate segment).  The build is
vectorized over (doc, term) pairs instead of the reference's per-doc and
per-term loops; the arithmetic per posting is unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve_device

BLOCK = 128  # docs per bitmap block
WORDS_PER_BLOCK = BLOCK // 32
POSTING_BLOCK = 128  # postings per logical block


@dataclass(frozen=True)
class TextIndex:
    """Device-resident inverted index (a dataclass of tensors)."""

    postings: torch.Tensor  # i32[P]
    impacts: torch.Tensor  # f32[P]
    offsets: torch.Tensor  # i32[M+1]
    bitmaps: torch.Tensor  # u32[n_bitmap_terms, n_words]
    bitmap_term_ids: torch.Tensor  # i32[n_bitmap_terms]
    post_packed: torch.Tensor  # u32[0] (packed store: later slice)
    blk_first: torch.Tensor  # i32[0]
    blk_bits: torch.Tensor  # i32[0]
    blk_len: torch.Tensor  # i32[NB] valid postings per logical block
    blk_word_off: torch.Tensor  # i32[0]
    blk_pos: torch.Tensor  # i32[NB] CSR position of each block's 1st posting
    blk_term_off: torch.Tensor  # i32[M+1] CSR of blocks per term
    blk_max_impact: torch.Tensor  # f32[NB]
    blk_n_exc: torch.Tensor  # i32[0]
    seg_term_off: torch.Tensor  # i32[M+1] (degenerate under layout="docid")
    seg_pos: torch.Tensor  # i32[1]
    seg_len: torch.Tensor  # i32[1]
    n_docs: int
    n_terms: int
    max_term_blocks: int = 1
    layout: str = "docid"
    max_term_segments: int = 1

    @property
    def n_postings(self) -> int:
        return self.impacts.shape[0]

    @property
    def is_compressed(self) -> bool:
        return self.blk_first.shape[0] > 0

    @property
    def posting_bytes(self) -> float:
        """Modeled bytes per posting: doc id + impact (8 at f32)."""
        P = max(self.n_postings, 1)
        return (4.0 * P) / P + self.impacts.element_size()


def logical_posting_blocks_np(
    offsets: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """128-posting framing of a CSR store that never straddles a term:
    ``(blk_term_off i32[M+1], blk_pos i32[NB], blk_len i32[NB])``; an empty
    store yields one degenerate empty block."""
    M = len(offsets) - 1
    counts = np.diff(offsets.astype(np.int64))
    nb = (counts + POSTING_BLOCK - 1) // POSTING_BLOCK
    blk_term_off = np.zeros((M + 1,), np.int32)
    blk_term_off[1:] = np.cumsum(nb).astype(np.int32)
    NB = int(blk_term_off[-1])
    if NB == 0:
        return blk_term_off, np.zeros((1,), np.int32), np.zeros((1,), np.int32)
    term_of_blk = np.repeat(np.arange(M), nb)
    k = np.arange(NB, dtype=np.int64) - np.repeat(blk_term_off[:-1], nb)
    poss = offsets[term_of_blk].astype(np.int64) + k * POSTING_BLOCK
    lens = np.minimum(counts[term_of_blk] - k * POSTING_BLOCK, POSTING_BLOCK)
    return blk_term_off, poss.astype(np.int32), lens.astype(np.int32)


def block_max_impacts_np(
    impacts: np.ndarray, blk_pos: np.ndarray, blk_len: np.ndarray
) -> np.ndarray:
    """Per-block max of the stored impacts, f32[NB]; empty blocks get 0."""
    out = np.zeros((blk_pos.shape[0],), np.float32)
    live = blk_len > 0
    if live.any():
        # blocks tile the CSR contiguously and in order
        out[live] = np.maximum.reduceat(
            np.asarray(impacts).astype(np.float32), blk_pos[live]
        )
    return out


def build_text_index_np(
    doc_terms: list[np.ndarray],
    n_terms: int,
    n_bitmap_terms: int = 0,
    idf: np.ndarray | None = None,
    device: "str | torch.device | None" = None,
) -> TextIndex:
    """Build from per-doc term-id arrays (repetitions = frequencies); the
    index equals the reference's ``compress=False, layout="docid"`` build
    and lives on ``device`` (default CUDA)."""
    arrays, statics = build_text_arrays_np(doc_terms, n_terms, n_bitmap_terms, idf)
    return text_index_from_numpy(arrays, statics, device)


def build_text_arrays_np(
    doc_terms: list[np.ndarray],
    n_terms: int,
    n_bitmap_terms: int = 0,
    idf: np.ndarray | None = None,
) -> tuple[dict[str, np.ndarray], dict]:
    """The numpy build behind :func:`build_text_index_np`: the
    :class:`TextIndex` array fields plus its statics."""
    n_docs = len(doc_terms)
    lens = np.fromiter((len(t) for t in doc_terms), np.int64, n_docs)
    doc_len = np.maximum(lens, 1).astype(np.float64)
    flat = (
        np.concatenate(doc_terms).astype(np.int64) if n_docs else np.zeros((0,), np.int64)
    )
    doc_of = np.repeat(np.arange(n_docs, dtype=np.int64), lens)
    # distinct (term, doc) pairs in (term, doc) order = the CSR order; the
    # pair multiplicity is the term frequency in that doc
    key, freq = np.unique(flat * max(n_docs, 1) + doc_of, return_counts=True)
    term = key // max(n_docs, 1)
    doc = key - term * max(n_docs, 1)

    df = np.bincount(term, minlength=n_terms).astype(np.float64)
    if idf is None:
        idf = np.log(1.0 + n_docs / np.maximum(df, 1.0))
    offsets = np.zeros((n_terms + 1,), dtype=np.int32)
    offsets[1:] = np.cumsum(df.astype(np.int64))
    postings = doc.astype(np.int32)
    impacts = (
        idf[term] * (1.0 + np.log(freq.astype(np.float64))) / np.sqrt(doc_len[doc])
    ).astype(np.float32)

    # block bitmaps for the most frequent terms
    n_words = (n_docs + BLOCK - 1) // BLOCK * WORDS_PER_BLOCK
    if n_bitmap_terms > 0:
        top_terms = np.argsort(-df)[:n_bitmap_terms].astype(np.int32)
        bitmaps = np.zeros((n_bitmap_terms, n_words), dtype=np.uint32)
        for row, w in enumerate(top_terms):
            ids = postings[offsets[w] : offsets[w + 1]]
            np.bitwise_or.at(bitmaps[row], ids // 32, np.uint32(1) << (ids % 32).astype(np.uint32))
    else:
        top_terms = np.zeros((0,), dtype=np.int32)
        bitmaps = np.zeros((0, n_words), dtype=np.uint32)

    blk_term_off, blk_pos, blk_len = logical_posting_blocks_np(offsets)
    z = np.zeros((0,), np.int32)
    arrays = dict(
        postings=postings,
        impacts=impacts,
        offsets=offsets,
        bitmaps=bitmaps,
        bitmap_term_ids=top_terms,
        post_packed=np.zeros((0,), np.uint32),
        blk_first=z,
        blk_bits=z,
        blk_len=blk_len,
        blk_word_off=z,
        blk_pos=blk_pos,
        blk_term_off=blk_term_off,
        blk_max_impact=block_max_impacts_np(impacts, blk_pos, blk_len),
        blk_n_exc=z,
        seg_term_off=np.zeros((n_terms + 1,), np.int32),
        seg_pos=np.zeros((1,), np.int32),
        seg_len=np.zeros((1,), np.int32),
    )
    statics = dict(
        n_docs=n_docs,
        n_terms=n_terms,
        max_term_blocks=int(max(np.diff(blk_term_off).max(initial=0), 1)),
        layout="docid",
        max_term_segments=1,
    )
    return arrays, statics


def text_index_from_numpy(arrays: dict[str, np.ndarray], statics: dict, device=None) -> TextIndex:
    """A :class:`TextIndex` on ``device`` from its numpy fields.  Only the
    uncompressed docid layout is supported in this slice."""
    if statics.get("layout", "docid") != "docid" or np.asarray(arrays["blk_first"]).shape[0]:
        raise NotImplementedError(
            "the packed PForDelta store and layout='impact' are not ported yet "
            "(they arrive with the TEXT-FIRST slice)"
        )
    dev = resolve_device(device)
    return TextIndex(
        **{k: torch.from_numpy(np.array(v)).to(dev) for k, v in arrays.items()},
        n_docs=int(statics["n_docs"]),
        n_terms=int(statics["n_terms"]),
        max_term_blocks=int(statics.get("max_term_blocks", 1)),
        layout="docid",
        max_term_segments=int(statics.get("max_term_segments", 1)),
    )


# ---------------------------------------------------------------------------
# Query-time primitives, batched: one row per query
# ---------------------------------------------------------------------------

def term_slice(index: TextIndex, term: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(start, length) of each term's posting slice."""
    t = term.long()
    lo = index.offsets[t]
    return lo, index.offsets[t + 1] - lo


def _searchsorted_slice(
    arr: torch.Tensor, lo: torch.Tensor, n: torch.Tensor, keys: torch.Tensor
) -> torch.Tensor:
    """Branchless left bisection of ``keys`` in ``arr[lo:lo+n)``.

    ``lo``/``n`` broadcast against ``keys``; a fixed ``ceil(log2(P))+1``
    steps with the overflow-safe midpoint ``l + (h-l)//2``.  Returns
    absolute positions in ``[lo, lo+n]``, i32.
    """
    P = arr.shape[0]
    steps = max(int(np.ceil(np.log2(max(P, 2)))) + 1, 1)
    l = torch.broadcast_to(lo, keys.shape).to(torch.int32)
    h = torch.broadcast_to(lo + n, keys.shape).to(torch.int32)
    for _ in range(steps):
        active = l < h
        mid = l + torch.div(h - l, 2, rounding_mode="floor")
        v = arr[torch.clamp(mid, 0, P - 1).long()]
        go_right = v < keys
        l = torch.where(active & go_right, mid + 1, l)
        h = torch.where(active & ~go_right, mid, h)
    return l


def probe_term(
    index: TextIndex, term: torch.Tensor, doc_ids: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Membership + impact of ``doc_ids [B, C]`` in each row's term
    (``term i32[B]``) by bisection of the term slice."""
    lo, n = term_slice(index, term)
    lo, n = lo[:, None], n[:, None]
    pos = _searchsorted_slice(index.postings, lo, n, doc_ids)
    safe_pos = torch.clamp(pos, 0, index.n_postings - 1).long()
    member = (pos < lo + n) & (index.postings[safe_pos] == doc_ids) & (n > 0)
    impact = torch.where(member, index.impacts[safe_pos].float(), 0.0)
    return member, impact


def _text_probe_loop(index, terms, doc_ids, valid=None):
    """Shared term loop of the two ``text_score_of_docs`` variants.  Terms
    that are padding in every row are skipped: they change nothing."""
    B, d = terms.shape
    match = torch.ones(doc_ids.shape, dtype=torch.bool, device=doc_ids.device)
    score = torch.zeros(doc_ids.shape, dtype=torch.float32, device=doc_ids.device)
    probes = torch.zeros((B,), dtype=torch.int32, device=doc_ids.device)
    real_any = (terms >= 0).any(dim=0).tolist()
    for i in range(d):
        if not real_any[i]:
            continue
        t = terms[:, i]
        is_real = (t >= 0)[:, None]
        if valid is not None:
            live = (match & valid).sum(dim=1, dtype=torch.int32)
            probes = probes + torch.where(is_real[:, 0], live, 0)
        member, imp = probe_term(index, torch.clamp(t, min=0), doc_ids)
        match = match & (member | ~is_real)
        score = score + torch.where(is_real, imp, 0.0)
    return match, score, probes


def text_score_of_docs(
    index: TextIndex,
    terms: torch.Tensor,  # i32[B, d] padded with -1
    doc_ids: torch.Tensor,  # i32[B, C]
) -> tuple[torch.Tensor, torch.Tensor]:
    """AND-semantics text score: (match bool[B, C], score f32[B, C])."""
    match, score, _ = _text_probe_loop(index, terms, doc_ids)
    return match, score


def text_score_of_docs_counted(
    index: TextIndex,
    terms: torch.Tensor,  # i32[B, d]
    doc_ids: torch.Tensor,  # i32[B, C]
    valid: torch.Tensor,  # bool[B, C] — candidates live before term 0
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``text_score_of_docs`` plus the probes a short-circuiting evaluator
    issues (only candidates still matching every earlier term are probed):
    (match, score, probes i32[B])."""
    return _text_probe_loop(index, terms, doc_ids, valid)
