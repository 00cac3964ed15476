"""Inverted text index: CSR postings + impact scores
(port of ``repro/core/text_index.py``, every storage mode and layout).

* ``postings i32[P]`` — doc ids (``[0]`` when compressed, see below).
* ``impacts f32[P]`` (f16 under compression) — each posting's full lnc.ltc
  contribution ``ln(1 + n/f_t) · (1 + ln f_{D,t}) / sqrt(|D|)``.
* ``offsets i32[M+1]`` — term w owns ``postings[offsets[w]:offsets[w+1]]``.
* logical 128-posting blocks (``blk_term_off/blk_pos/blk_len``) with their
  ``blk_max_impact`` — the pruned TEXT-FIRST's skip unit.
* optional u32 block bitmaps for the most frequent terms.

``compress=True`` replaces the doc-id column by the PForDelta store:
``post_packed u32[W]`` holds each block's deltas at a base width
``blk_bits`` (``ceil(len·bits/32)`` tail-trimmed words) followed by
``blk_n_exc`` patch words ``slot | high_bits << 8``; ``blk_first`` and
``blk_word_off`` address the blocks.  ``layout="impact"`` regroups each
term's postings into descending quantized-impact segments (doc ids ascend
within a segment; ``seg_term_off/seg_pos/seg_len``), frames blocks per
segment and widens ``blk_max_impact`` into a per-term suffix-max envelope.
See the reference's module docstring for the design; the arrays here are
the reference's, field for field, down to dtype.

The build is vectorized over (doc, term) pairs, blocks and segments instead
of the reference's per-doc, per-term and per-block Python loops; the
arithmetic per posting and per block is unchanged.  Query-side functions
take an explicit batch axis.  torch has no ``>>``/``<<`` for ``uint32`` on
the CPU, so the decode gathers the packed words through an int32 view and
does its shifts and masks in int64.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve_device, to_numpy

BLOCK = 128  # docs per bitmap block
WORDS_PER_BLOCK = BLOCK // 32
POSTING_BLOCK = 128  # postings per logical / compression block
# PForDelta patch word: slot (8 bits, block slots < 128) | high_bits << 8
PFOR_SLOT_BITS = 8
PFOR_HIGH_BITS = 32 - PFOR_SLOT_BITS
# impact-ordered layout: global geometric levels (see the reference)
IMPACT_LEVELS = 32
IMPACT_LEVEL_RATIO = 1.2
INVALID = 2**31 - 1
LAYOUTS = ("docid", "impact")


@dataclass(frozen=True)
class TextIndex:
    """Device-resident inverted index (a dataclass of tensors)."""

    postings: torch.Tensor  # i32[P] doc ids ([0] when compressed)
    impacts: torch.Tensor  # f32[P] (f16 under compression)
    offsets: torch.Tensor  # i32[M+1]
    bitmaps: torch.Tensor  # u32[n_bitmap_terms, n_words]
    bitmap_term_ids: torch.Tensor  # i32[n_bitmap_terms]
    post_packed: torch.Tensor  # u32[W] packed deltas ([0] uncompressed)
    blk_first: torch.Tensor  # i32[NB] first doc id per block ([0] raw)
    blk_bits: torch.Tensor  # i32[NB] base delta width ([0] raw)
    blk_len: torch.Tensor  # i32[NB] valid postings per logical block
    blk_word_off: torch.Tensor  # i32[NB] start word in post_packed ([0] raw)
    blk_pos: torch.Tensor  # i32[NB] CSR position of each block's 1st posting
    blk_term_off: torch.Tensor  # i32[M+1] CSR of blocks per term
    blk_max_impact: torch.Tensor  # f32[NB] (suffix-max envelope under "impact")
    blk_n_exc: torch.Tensor  # i32[NB] PForDelta patch words ([0] raw)
    seg_term_off: torch.Tensor  # i32[M+1] (degenerate under layout="docid")
    seg_pos: torch.Tensor  # i32[NS]
    seg_len: torch.Tensor  # i32[NS]
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
        """Modeled bytes per posting: doc id (packed words and 20 B of block
        metadata when compressed) + impact, plus 8 B per segment under the
        impact layout — the reference's formula."""
        P = max(self.n_postings, 1)
        imp = self.impacts.element_size()
        seg = 8 * self.seg_pos.shape[0] if self.layout == "impact" else 0
        if self.is_compressed:
            packed = 4 * self.post_packed.shape[0] + 20 * self.blk_first.shape[0]
            return (packed + seg) / P + imp
        return (4.0 * P + seg) / P + imp


# ---------------------------------------------------------------------------
# Build (host numpy)
# ---------------------------------------------------------------------------

def logical_posting_blocks_np(
    offsets: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """128-posting framing of a CSR store that never straddles a term:
    ``(blk_term_off i32[M+1], blk_pos i32[NB], blk_len i32[NB])``; an empty
    store yields one degenerate empty block."""
    M = len(offsets) - 1
    counts = np.diff(np.asarray(offsets, np.int64))
    nb = (counts + POSTING_BLOCK - 1) // POSTING_BLOCK
    blk_term_off = np.zeros((M + 1,), np.int32)
    blk_term_off[1:] = np.cumsum(nb).astype(np.int32)
    NB = int(blk_term_off[-1])
    if NB == 0:
        return blk_term_off, np.zeros((1,), np.int32), np.zeros((1,), np.int32)
    term_of_blk = np.repeat(np.arange(M), nb)
    k = np.arange(NB, dtype=np.int64) - np.repeat(blk_term_off[:-1], nb)
    poss = np.asarray(offsets, np.int64)[term_of_blk] + k * POSTING_BLOCK
    lens = np.minimum(counts[term_of_blk] - k * POSTING_BLOCK, POSTING_BLOCK)
    return blk_term_off, poss.astype(np.int32), lens.astype(np.int32)


def block_max_impacts_np(
    impacts: np.ndarray, blk_pos: np.ndarray, blk_len: np.ndarray
) -> np.ndarray:
    """Per-block max of the stored impacts decoded to f32, f32[NB]; empty
    blocks get 0."""
    out = np.zeros((blk_pos.shape[0],), np.float32)
    live = blk_len > 0
    if live.any():
        # blocks tile the CSR contiguously and in order (both layouts)
        out[live] = np.maximum.reduceat(
            np.asarray(impacts).astype(np.float32), blk_pos[live]
        )
    return out


def _empty_pack(offsets: np.ndarray) -> dict[str, np.ndarray]:
    """Uncompressed layout: zero-width packed columns + logical blocks."""
    z = np.zeros((0,), np.int32)
    blk_term_off, blk_pos, blk_len = logical_posting_blocks_np(offsets)
    return dict(
        post_packed=np.zeros((0,), np.uint32), blk_first=z, blk_bits=z,
        blk_len=blk_len, blk_word_off=z, blk_pos=blk_pos,
        blk_term_off=blk_term_off, blk_n_exc=z,
    )


def _bit_length(v: np.ndarray) -> np.ndarray:
    """``int.bit_length`` of non-negative int64 values below 2^53, i64."""
    return np.frexp(np.asarray(v, np.int64).astype(np.float64))[1].astype(np.int64)


def _pfor_width_np(real_deltas: np.ndarray) -> tuple[int, int]:
    """One block's PForDelta base width — ``(bits, n_exc)`` — by the
    reference's rule (the one-block form of :func:`_pfor_widths`)."""
    d = np.ones((1, POSTING_BLOCK), np.int64)
    d[0, : len(real_deltas)] = real_deltas
    bits, n_exc = _pfor_widths(d, np.asarray([len(real_deltas)], np.int64))
    return int(bits[0]), int(n_exc[0])


def _pfor_widths(deltas: np.ndarray, lens: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Every block's PForDelta base width at once: ``(bits, n_exc)`` i64[NB].

    The reference minimizes ``max(ceil(len·w/32), 1) + n_exc(w)`` over
    ``w ∈ [max(1, maxbits−24), maxbits)``, scanning widths upward with a
    strict ``<`` against the no-exception width ``maxbits``: so ``maxbits``
    wins a tie, and among narrower widths the lowest minimal one does.
    ``n_exc(w)`` counts the real deltas longer than ``w`` bits, read off a
    per-block histogram of bit lengths.
    """
    NB = deltas.shape[0]
    j = np.arange(POSTING_BLOCK)[None, :]
    real = j < lens[:, None]
    bl = np.where(real, _bit_length(deltas), 0)  # [NB, 128]
    maxbits = np.maximum(bl.max(axis=1), 1)
    hist = np.bincount(
        (np.arange(NB)[:, None] * 65 + bl)[real], minlength=NB * 65
    ).reshape(NB, 65)
    # longer[b, w] = number of real deltas with bit length > w
    longer = np.cumsum(hist[:, ::-1], axis=1)[:, ::-1]
    longer = np.concatenate([longer[:, 1:], np.zeros((NB, 1), np.int64)], axis=1)
    w = np.arange(1, 32)[None, :]
    words = np.maximum(-(-lens[:, None] * w // 32), 1) + longer[:, 1:32]
    allowed = (w >= np.maximum(1, maxbits[:, None] - PFOR_HIGH_BITS)) & (w < maxbits[:, None])
    words = np.where(allowed, words, np.iinfo(np.int64).max)
    best_w = np.argmin(words, axis=1) + 1  # first (lowest) minimal width
    best_words = words[np.arange(NB), best_w - 1]
    base_words = np.maximum(-(-lens * maxbits // 32), 1)
    narrower = best_words < base_words
    bits = np.where(narrower, best_w, maxbits)
    n_exc = np.where(narrower, longer[np.arange(NB), np.minimum(bits, 64)], 0)
    return bits.astype(np.int64), n_exc.astype(np.int64)


def pack_postings_np(
    postings: np.ndarray,
    offsets: np.ndarray,
    impacts: np.ndarray | None = None,
) -> dict[str, np.ndarray]:
    """Delta + PForDelta bit-pack each frame's postings into 128-posting
    blocks (the reference's ``pack_postings_np``, vectorized over blocks).

    Within a block slot 0 stores delta 0 (its doc id is ``blk_first``) and
    slots past the block's length delta 1; every slot's low ``bits`` bits
    are packed little-endian, the block keeps ``max(ceil(len·bits/32), 1)``
    words, then one patch word per real delta longer than ``bits``.  With
    ``impacts`` the dict also carries ``blk_max_impact``.
    """
    blk_term_off, blk_pos, blk_len = logical_posting_blocks_np(offsets)
    if int(blk_term_off[-1]) == 0:  # empty store: one degenerate empty block
        out = dict(
            post_packed=np.zeros((4,), np.uint32),
            blk_first=np.zeros((1,), np.int32), blk_bits=np.ones((1,), np.int32),
            blk_len=blk_len, blk_word_off=np.zeros((1,), np.int32), blk_pos=blk_pos,
            blk_term_off=blk_term_off, blk_n_exc=np.zeros((1,), np.int32),
        )
    else:
        post = np.asarray(postings, np.int64)
        NB = blk_pos.shape[0]
        lens = blk_len.astype(np.int64)
        j = np.arange(POSTING_BLOCK, dtype=np.int64)[None, :]
        real = j < lens[:, None]
        p = np.minimum(blk_pos.astype(np.int64)[:, None] + j, max(len(post) - 1, 0))
        ids = post[p]
        deltas = np.ones((NB, POSTING_BLOCK), np.int64)
        deltas[:, 1:] = ids[:, 1:] - ids[:, :-1]
        deltas[:, 0] = 0
        deltas = np.where(real | (j == 0), deltas, 1)
        bits, n_exc = _pfor_widths(deltas, lens)
        # base words: slot j's low bits land at bit j·bits of the block's
        # untrimmed 4·bits words; fields never overlap, so OR == sum and a
        # float64 bincount (exact below 2^53) builds the words
        low = deltas & ((np.int64(1) << bits[:, None]) - 1)
        bitpos = j * bits[:, None]
        wi = bitpos >> 5
        shifted = low << (bitpos & 31)  # < 2^62
        nw = POSTING_BLOCK * bits // 32
        full_off = np.concatenate([[0], np.cumsum(nw)[:-1]])
        lo_idx = full_off[:, None] + wi
        hi_idx = full_off[:, None] + np.minimum(wi + 1, nw[:, None] - 1)
        total = int(nw.sum())
        words = np.bincount(
            np.concatenate([lo_idx.reshape(-1), hi_idx.reshape(-1)]),
            weights=np.concatenate([
                (shifted & 0xFFFFFFFF).reshape(-1).astype(np.float64),
                (shifted >> 32).reshape(-1).astype(np.float64),
            ]),
            minlength=total,
        ).astype(np.uint64)
        # tail-trim each block, then append its patch words
        nw_t = np.maximum(-(-lens * bits // 32), 1)
        word_off = np.concatenate([[0], np.cumsum(nw_t + n_exc)[:-1]])
        packed = np.zeros((int((nw_t + n_exc).sum()),), np.uint64)
        blk_of = np.repeat(np.arange(NB), nw_t)
        k = np.arange(len(blk_of)) - np.repeat(np.cumsum(nw_t) - nw_t, nw_t)
        packed[word_off[blk_of] + k] = words[full_off[blk_of] + k]
        exc = real & ((deltas >> bits[:, None]) != 0)
        eb, es = np.nonzero(exc)  # blocks ascending, slots ascending within
        rank = np.arange(len(eb)) - np.repeat(np.cumsum(n_exc) - n_exc, n_exc)
        high = deltas[eb, es] >> bits[eb]
        packed[word_off[eb] + nw_t[eb] + rank] = es | (high << PFOR_SLOT_BITS)
        out = dict(
            post_packed=packed.astype(np.uint32),
            blk_first=ids[:, 0].astype(np.int32),
            blk_bits=bits.astype(np.int32),
            blk_len=blk_len,
            blk_word_off=word_off.astype(np.int32),
            blk_pos=blk_pos,
            blk_term_off=blk_term_off,
            blk_n_exc=n_exc.astype(np.int32),
        )
    if impacts is not None:
        out["blk_max_impact"] = block_max_impacts_np(impacts, out["blk_pos"], out["blk_len"])
    return out


def impact_levels_np(impacts: np.ndarray) -> np.ndarray:
    """Global geometric impact level per posting — i32, 0 = highest."""
    v = np.asarray(impacts, np.float32).astype(np.float64)
    vmax = float(v.max(initial=0.0))
    if vmax <= 0.0:
        return np.zeros(v.shape, np.int32)
    lvl = np.floor(
        np.log(vmax / np.maximum(v, vmax * 1e-12)) / np.log(IMPACT_LEVEL_RATIO)
    )
    return np.clip(lvl, 0, IMPACT_LEVELS - 1).astype(np.int32)


def _impact_order_np(
    postings: np.ndarray, impacts: np.ndarray, offsets: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Reorder each term's slice into descending-impact-level segments,
    doc ids ascending within a segment: ``(postings, impacts, seg_term_off,
    seg_pos, seg_len)``.  One global lexsort by (term, level, doc id)."""
    lvl = impact_levels_np(impacts)
    M = len(offsets) - 1
    P = len(postings)
    counts = np.diff(np.asarray(offsets, np.int64))
    term = np.repeat(np.arange(M), counts)
    order = np.lexsort((postings, lvl, term))
    post2, imp2, lv, tm = postings[order], impacts[order], lvl[order], term[order]
    new = np.ones((P,), bool)
    new[1:] = (lv[1:] != lv[:-1]) | (tm[1:] != tm[:-1])
    seg_pos = np.flatnonzero(new)
    seg_len = np.diff(np.append(seg_pos, P))
    seg_term_off = np.zeros((M + 1,), np.int32)
    seg_term_off[1:] = np.cumsum(np.bincount(tm[seg_pos], minlength=M))
    if P == 0:  # empty store: one degenerate empty segment
        seg_pos, seg_len = np.zeros((1,), np.int64), np.zeros((1,), np.int64)
    return (
        post2, imp2, seg_term_off,
        seg_pos.astype(np.int32), seg_len.astype(np.int32),
    )


def _suffix_max_per_term_np(blk_max: np.ndarray, blk_term_off: np.ndarray) -> np.ndarray:
    """Per-term suffix-max envelope of block maxima, f32[NB]: ``out[b] =
    max(blk_max[b : term_end])``, by log-step doubling over the blocks."""
    out = np.asarray(blk_max, np.float32).copy()
    nb = np.diff(np.asarray(blk_term_off, np.int64))
    n_own = int(nb.sum())
    end = np.repeat(np.asarray(blk_term_off[1:], np.int64), nb)
    idx = np.arange(n_own)
    step = 1
    while step < max(int(nb.max(initial=0)), 1):
        nxt = idx + step
        ok = nxt < end
        prev = out[:n_own].copy()
        out[:n_own][ok] = np.maximum(prev[ok], prev[nxt[ok]])
        step *= 2
    return out


def _trivial_segments_np(M: int) -> dict[str, np.ndarray]:
    """Degenerate segment columns for layout="docid" (never probed)."""
    return dict(
        seg_term_off=np.zeros((M + 1,), np.int32),
        seg_pos=np.zeros((1,), np.int32),
        seg_len=np.zeros((1,), np.int32),
    )


def build_text_index_np(
    doc_terms: list[np.ndarray],
    n_terms: int,
    n_bitmap_terms: int = 0,
    idf: np.ndarray | None = None,
    compress: bool = False,
    impact_dtype: "np.dtype | str | None" = None,
    layout: str = "docid",
    device: "str | torch.device | None" = None,
) -> TextIndex:
    """Build from per-doc term-id arrays (repetitions = frequencies); the
    index equals the reference's build with the same arguments and lives on
    ``device`` (default CUDA)."""
    arrays, statics = build_text_arrays_np(
        doc_terms, n_terms, n_bitmap_terms, idf, compress, impact_dtype, layout
    )
    return text_index_from_numpy(arrays, statics, device)


def build_text_arrays_np(
    doc_terms: list[np.ndarray],
    n_terms: int,
    n_bitmap_terms: int = 0,
    idf: np.ndarray | None = None,
    compress: bool = False,
    impact_dtype: "np.dtype | str | None" = None,
    layout: str = "docid",
) -> tuple[dict[str, np.ndarray], dict]:
    """The numpy build behind :func:`build_text_index_np`: the
    :class:`TextIndex` array fields plus its statics.  ``impact_dtype``
    quantizes the impact column before the layout and block maxima are
    derived from it, as in the reference."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown posting layout: {layout!r}")
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

    if impact_dtype is not None:
        impacts = impacts.astype(impact_dtype)
    if layout == "impact":
        postings, impacts, seg_term_off, seg_pos, seg_len = _impact_order_np(
            postings, impacts, offsets
        )
        seg = dict(seg_term_off=seg_term_off, seg_pos=seg_pos, seg_len=seg_len)
        # blocks never straddle a segment: segment ends are the frame CSR
        NS = int(seg_term_off[-1])
        frame_off = np.zeros((NS + 1,), np.int64)
        frame_off[1:] = (seg_pos[:NS] + seg_len[:NS]).astype(np.int64)
    else:
        seg = _trivial_segments_np(n_terms)
        frame_off = offsets
    if compress:
        pack = pack_postings_np(postings, frame_off, impacts=impacts)
        postings = np.zeros((0,), np.int32)  # the packed words are the store
    else:
        pack = _empty_pack(frame_off)
        pack["blk_max_impact"] = block_max_impacts_np(impacts, pack["blk_pos"], pack["blk_len"])
    if layout == "impact":
        # per-segment block CSR back to per-term, and the monotone envelope
        pack["blk_term_off"] = pack["blk_term_off"][seg["seg_term_off"]]
        pack["blk_max_impact"] = _suffix_max_per_term_np(
            pack["blk_max_impact"], pack["blk_term_off"]
        )
    arrays = dict(
        postings=postings, impacts=impacts, offsets=offsets, bitmaps=bitmaps,
        bitmap_term_ids=top_terms, **pack, **seg,
    )
    statics = dict(
        n_docs=n_docs,
        n_terms=n_terms,
        max_term_blocks=int(max(np.diff(pack["blk_term_off"]).max(initial=0), 1)),
        layout=layout,
        max_term_segments=int(max(np.diff(seg["seg_term_off"]).max(initial=0), 1)),
    )
    return arrays, statics


def text_index_from_numpy(arrays: dict[str, np.ndarray], statics: dict, device=None) -> TextIndex:
    """A :class:`TextIndex` on ``device`` from its numpy fields (the
    reference's field names; any storage mode and layout)."""
    layout = statics.get("layout", "docid")
    if layout not in LAYOUTS:
        raise ValueError(f"unknown posting layout: {layout!r}")
    dev = resolve_device(device)
    return TextIndex(
        **{k: torch.from_numpy(np.array(v)).to(dev) for k, v in arrays.items()},
        n_docs=int(statics["n_docs"]),
        n_terms=int(statics["n_terms"]),
        max_term_blocks=int(statics.get("max_term_blocks", 1)),
        layout=layout,
        max_term_segments=int(statics.get("max_term_segments", 1)),
    )


def global_idf_np(doc_terms: list[np.ndarray], n_terms: int) -> np.ndarray:
    """Corpus-wide IDF, f64[M], the formula :func:`build_text_arrays_np`
    applies.  Document frequencies are integer counts of distinct (term,
    doc) pairs (exact in float64, as the reference's per-doc ``np.add.at``
    loop), so the logarithms are the reference's bit for bit."""
    n_docs = len(doc_terms)
    df = np.zeros((n_terms,), dtype=np.float64)
    if n_docs:
        lens = np.fromiter((len(t) for t in doc_terms), np.int64, n_docs)
        flat = np.concatenate(doc_terms).astype(np.int64)
        doc_of = np.repeat(np.arange(n_docs, dtype=np.int64), lens)
        key = np.unique(flat * n_docs + doc_of)
        df += np.bincount(key // n_docs, minlength=n_terms)[:n_terms]
    return np.log(1.0 + n_docs / np.maximum(df, 1.0))


def _with_impacts(index: TextIndex, impacts: np.ndarray) -> TextIndex:
    """Replace the impact column and refresh ``blk_max_impact`` to match
    (re-enveloped per term under the impact layout, as in the reference)."""
    bm = block_max_impacts_np(impacts, to_numpy(index.blk_pos), to_numpy(index.blk_len))
    if index.layout == "impact":
        bm = _suffix_max_per_term_np(bm, to_numpy(index.blk_term_off))
    dev = index.offsets.device
    return dataclasses.replace(
        index,
        impacts=torch.from_numpy(np.ascontiguousarray(impacts)).to(dev),
        blk_max_impact=torch.from_numpy(bm).to(dev),
    )


def rescale_impacts_to_global(index: TextIndex, idf_global: np.ndarray) -> TextIndex:
    """Swap a shard-local index's IDF for the corpus-global one: each
    posting's impact times ``idf_global / idf_local`` of its term (the
    reference's arithmetic, f32 product).  The sharded builders do not use
    it: they pass the global IDF into the build, so impacts round to f32
    once and are bitwise equal across partitionings."""
    offsets = to_numpy(index.offsets)
    counts = np.diff(offsets)
    idf_local = np.log(1.0 + index.n_docs / np.maximum(counts.astype(np.float64), 1.0))
    ratio = np.where(counts > 0, idf_global / idf_local, 1.0)
    impacts = to_numpy(index.impacts) * np.repeat(ratio, counts).astype(np.float32)
    return _with_impacts(index, impacts)


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
        v = arr[torch.clamp(mid, 0, max(P - 1, 0)).long()]
        go_right = v < keys
        l = torch.where(active & go_right, mid + 1, l)
        h = torch.where(active & ~go_right, mid, h)
    return l


def _packed_words(index: TextIndex, word: torch.Tensor) -> torch.Tensor:
    """``post_packed[clip(word)]`` as int64 in [0, 2^32): gathered through
    an int32 view (uint32 has no shifts on the CPU), then widened."""
    W = max(index.post_packed.shape[0], 1)
    w = index.post_packed.view(torch.int32)[torch.clamp(word, 0, W - 1).long()]
    return w.to(torch.int64) & 0xFFFFFFFF


def decode_posting_blocks(index: TextIndex, blocks: torch.Tensor) -> torch.Tensor:
    """Decode compressed blocks to doc ids — i32[..., POSTING_BLOCK].

    Two-word shift/mask extraction of the 128 base-width deltas, the
    block's PForDelta patch words added in one scatter (up to the largest
    patch count among ``blocks``), then a prefix sum from ``blk_first``.
    Slots past ``blk_len`` are garbage; consumers mask them.
    """
    b = blocks.long()
    bits = index.blk_bits[b].to(torch.int64)
    w0 = index.blk_word_off[b].to(torch.int64)
    j = torch.arange(POSTING_BLOCK, dtype=torch.int64, device=blocks.device)
    bitpos = j * bits[..., None]
    word = w0[..., None] + (bitpos >> 5)
    off = bitpos & 31
    lo_w = _packed_words(index, word)
    hi_w = _packed_words(index, word + 1)
    hi_part = torch.where(off > 0, (hi_w << ((32 - off) & 31)) & 0xFFFFFFFF, 0)
    mask = (torch.ones_like(bits) << bits)[..., None] - 1  # bits ≤ 31
    delta = ((lo_w >> off) | hi_part) & mask
    delta = torch.where(j == 0, 0, delta)
    n_exc = index.blk_n_exc[b].to(torch.int64)
    E = int(n_exc.max()) if n_exc.numel() else 0
    if E:
        # all patch words at once: word e of a block restores the high bits
        # of its slot (distinct slots; words past n_exc add nothing)
        base_words = torch.clamp((index.blk_len[b].to(torch.int64) * bits + 31) >> 5, min=1)
        e = torch.arange(E, dtype=torch.int64, device=blocks.device)
        pw = _packed_words(index, (w0 + base_words)[..., None] + e)
        slot = torch.clamp(pw & ((1 << PFOR_SLOT_BITS) - 1), max=POSTING_BLOCK - 1)
        add = torch.where(e < n_exc[..., None], (pw >> PFOR_SLOT_BITS) << bits[..., None], 0)
        delta = delta.scatter_add(-1, slot, add)
    first = index.blk_first[b].to(torch.int32)
    return first[..., None] + torch.cumsum(delta.to(torch.int32), dim=-1, dtype=torch.int32)


def _block_hit(index, blk, in_range, doc_ids):
    """Membership and impact of each key in its candidate block ``blk``
    (decoded), masked by ``in_range`` and the block's valid length."""
    NB = index.blk_first.shape[0]
    blk_s = torch.clamp(blk, 0, NB - 1).long()
    decoded = decode_posting_blocks(index, blk_s)  # [..., 128]
    j = torch.arange(POSTING_BLOCK, dtype=torch.int32, device=doc_ids.device)
    hit = (decoded == doc_ids[..., None]) & (j < index.blk_len[blk_s][..., None])
    member = in_range & hit.any(dim=-1)
    jpos = torch.argmax(hit.to(torch.int8), dim=-1).to(torch.int32)
    apos = torch.clamp(index.blk_pos[blk_s] + jpos, 0, index.n_postings - 1).long()
    impact = torch.where(member, index.impacts[apos].float(), 0.0)
    return member, impact


def _containing_block(index, b0, nb, doc_ids):
    """Last block of ``[b0, b0+nb)`` whose first doc id is ≤ the key, and
    whether it lies in the range."""
    NB = index.blk_first.shape[0]
    pos = _searchsorted_slice(index.blk_first, b0, nb, doc_ids)
    exact = (pos < b0 + nb) & (index.blk_first[torch.clamp(pos, 0, NB - 1).long()] == doc_ids)
    blk = torch.where(exact, pos, pos - 1)
    return blk, (blk >= b0) & (blk < b0 + nb)


def _probe_term_packed(index, term, doc_ids):
    """Compressed docid-layout probe: block-head bisection + one-block decode."""
    t = term.long()[:, None]
    b0 = index.blk_term_off[t]
    nb = index.blk_term_off[t + 1] - b0
    blk, in_range = _containing_block(index, b0, nb, doc_ids)
    return _block_hit(index, blk, in_range & (nb > 0), doc_ids)


def _probe_term_segmented(index, term, doc_ids):
    """Impact-layout probe: a bisection within each of the term's segments
    (doc ids ascend only within a segment); segment hits are disjoint, so
    the impacts add up to the one stored value.  The loop runs to the
    batch's largest segment count — later iterations of the reference's
    ``max_term_segments`` loop are dead (no live segment)."""
    t = term.long()
    s0 = index.seg_term_off[t][:, None]
    ns = (index.seg_term_off[t + 1] - index.seg_term_off[t])[:, None]
    NS = index.seg_pos.shape[0]
    member = torch.zeros(doc_ids.shape, dtype=torch.bool, device=doc_ids.device)
    impact = torch.zeros(doc_ids.shape, dtype=torch.float32, device=doc_ids.device)
    n_loop = min(index.max_term_segments, int(ns.max()) if ns.numel() else 0)
    b_off = index.blk_term_off[t][:, None]
    P = index.n_postings
    for i in range(n_loop):
        s = torch.clamp(s0 + i, 0, NS - 1).long()
        live = i < ns
        if index.is_compressed:
            # segments tile the term's block run contiguously: the running
            # block offset addresses this segment's ceil(len/128) blocks
            nb_s = torch.where(
                live, torch.div(index.seg_len[s] + POSTING_BLOCK - 1, POSTING_BLOCK,
                                rounding_mode="floor"), 0,
            )
            blk, in_range = _containing_block(index, b_off, nb_s, doc_ids)
            m, imp = _block_hit(index, blk, in_range, doc_ids)
            b_off = b_off + nb_s
        else:
            lo = index.seg_pos[s]
            n = torch.where(live, index.seg_len[s], 0)
            pos = _searchsorted_slice(index.postings, lo, n, doc_ids)
            safe = torch.clamp(pos, 0, P - 1).long()
            m = (pos < lo + n) & (index.postings[safe] == doc_ids) & (n > 0)
            imp = torch.where(m, index.impacts[safe].float(), 0.0)
        member = member | m
        impact = impact + imp
    return member, impact


def probe_term(
    index: TextIndex, term: torch.Tensor, doc_ids: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Membership + impact of ``doc_ids [B, C]`` in each row's term
    (``term i32[B]``): the segment-aware probe under the impact layout, the
    block-head probe when compressed, else bisection of the term slice."""
    if index.layout == "impact":
        return _probe_term_segmented(index, term, doc_ids)
    if index.is_compressed:
        return _probe_term_packed(index, term, doc_ids)
    lo, n = term_slice(index, term)
    lo, n = lo[:, None], n[:, None]
    pos = _searchsorted_slice(index.postings, lo, n, doc_ids)
    safe_pos = torch.clamp(pos, 0, index.n_postings - 1).long()
    member = (pos < lo + n) & (index.postings[safe_pos] == doc_ids) & (n > 0)
    impact = torch.where(member, index.impacts[safe_pos].float(), 0.0)
    return member, impact


def text_probe_loop(index, terms, doc_ids, valid=None, skip=None, match=None, score=None):
    """Shared term loop of the text scorers, from ``match`` (all true) and
    ``score`` (zeros): term column ``i`` is probed for the rows where it is
    real (and not ``skip``, the TEXT-FIRST driver), its impact added in
    column order.  A column that is live in no row is skipped: it changes
    nothing."""
    B, d = terms.shape
    if match is None:
        match = torch.ones(doc_ids.shape, dtype=torch.bool, device=doc_ids.device)
    if score is None:
        score = torch.zeros(doc_ids.shape, dtype=torch.float32, device=doc_ids.device)
    probes = torch.zeros((B,), dtype=torch.int32, device=doc_ids.device)
    real = terms >= 0
    if skip is not None:
        real = real & (torch.arange(d, device=terms.device)[None, :] != skip[:, None])
    real_any = real.any(dim=0).tolist()
    for i in range(d):
        if not real_any[i]:
            continue
        is_real = real[:, i, None]
        if valid is not None:
            live = (match & valid).sum(dim=1, dtype=torch.int32)
            probes = probes + torch.where(is_real[:, 0], live, 0)
        member, imp = probe_term(index, torch.clamp(terms[:, i], min=0), doc_ids)
        match = match & (member | ~is_real)
        score = score + torch.where(is_real, imp, 0.0)
    return match, score, probes


def text_score_of_docs(
    index: TextIndex,
    terms: torch.Tensor,  # i32[B, d] padded with -1
    doc_ids: torch.Tensor,  # i32[B, C]
) -> tuple[torch.Tensor, torch.Tensor]:
    """AND-semantics text score: (match bool[B, C], score f32[B, C])."""
    match, score, _ = text_probe_loop(index, terms, doc_ids)
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
    return text_probe_loop(index, terms, doc_ids, valid)


def driver_terms(index: TextIndex, terms: torch.Tensor):
    """TEXT-FIRST's driver: the real term with the shortest posting list,
    the first such column on a tie.  Returns ``(driver i64[B] column,
    t0 i64[B] term, any_real bool[B])``."""
    safe = torch.clamp(terms, min=0).long()
    lens = index.offsets[safe + 1] - index.offsets[safe]
    lens = torch.where(terms >= 0, lens, INVALID)
    driver = torch.argmin(lens, dim=1)
    t0 = torch.gather(safe, 1, driver[:, None])[:, 0]
    return driver, t0, terms[:, 0] >= 0


def driver_postings(index: TextIndex, terms: torch.Tensor, max_candidates: int):
    """The first ``max_candidates`` postings of each query's driver list:
    ``(cand i32[B, C], valid bool[B, C], impact f32[B, C], driver i64[B])``
    — decoded block by block when compressed; invalid slots hold INVALID
    and 0."""
    mc = max_candidates
    dev = terms.device
    driver, t0, any_real = driver_terms(index, terms)
    lo, n = term_slice(index, t0)
    n = torch.clamp(n, max=mc)
    idx = torch.arange(mc, dtype=torch.int64, device=dev)[None, :]
    valid = (idx < n[:, None]) & any_real[:, None]
    P = index.n_postings
    if index.is_compressed:
        # decode the driver's leading blocks once: ceil(mc/128), plus one
        # per segment boundary the window may cross (under the impact
        # layout each segment ends in a ragged block).  The reference
        # decodes only ceil(mc/128) blocks, so there a driver whose leading
        # segments are short yields garbage doc ids for the rest of its
        # window; the port decodes every posting of the window.
        NB = index.blk_first.shape[0]
        nbd = (mc + POSTING_BLOCK - 1) // POSTING_BLOCK + index.max_term_segments - 1
        blocks = torch.clamp(
            index.blk_term_off[t0][:, None] + torch.arange(nbd, device=dev), 0, NB - 1
        )
        decoded = decode_posting_blocks(index, blocks)  # [B, nbd, 128]
        if index.layout == "impact":
            # segment-restarted framing leaves ragged blocks mid-run: map
            # each CSR offset through the blocks' valid lengths
            cl = torch.cumsum(index.blk_len[blocks].long(), dim=1)
            bi = torch.searchsorted(cl, idx.expand(len(t0), mc).contiguous(), right=True)
            bi_s = torch.clamp(bi, 0, nbd - 1)
            prev = torch.gather(cl, 1, torch.clamp(bi - 1, min=0))
            lane = idx - torch.where(bi > 0, prev, 0)
            flat = bi_s * POSTING_BLOCK + torch.clamp(lane, 0, POSTING_BLOCK - 1)
            cand = torch.gather(decoded.reshape(len(t0), -1), 1, flat)
            apos = torch.clamp(lo[:, None] + idx, 0, P - 1)
        else:
            cand = decoded.reshape(len(t0), -1)[:, :mc]
            apos = torch.clamp(
                index.blk_pos[blocks].long()[..., None]
                + torch.arange(POSTING_BLOCK, device=dev), 0, P - 1,
            ).reshape(len(t0), -1)[:, :mc]
        imp = index.impacts[apos].float()
    else:
        pos = torch.clamp(lo[:, None] + idx, 0, P - 1)
        cand = index.postings[pos]
        imp = index.impacts[pos].float()
    cand = torch.where(valid, cand, INVALID).to(torch.int32)
    return cand, valid, torch.where(valid, imp, 0.0), driver


def conjunction_candidates(
    index: TextIndex,
    terms: torch.Tensor,  # i32[B, d] (padded with -1)
    max_candidates: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """TEXT-FIRST driver walk: the first ``max_candidates`` postings of the
    shortest list, probed against the other terms.  Returns ``(cand_ids
    i32[B, C], valid bool[B, C], text_score f32[B, C])``; invalid slots
    hold INVALID and 0."""
    cand, valid, score, driver = driver_postings(index, terms, max_candidates)
    valid, score, _ = text_probe_loop(index, terms, cand, skip=driver, match=valid, score=score)
    cand = torch.where(valid, cand, INVALID)
    score = torch.where(valid, score, 0.0)
    return cand, valid, score
