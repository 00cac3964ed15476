from repro_torch.corpus.synth import (
    ARRIVAL_KINDS,
    SynthCorpus,
    TraceQuery,
    make_arrivals,
    make_corpus,
    make_mixture_trace,
    make_query_trace,
    make_uniform_trace,
    make_zipf_trace,
    pad_trace_batch,
    stamp_arrivals,
    term_document_frequencies,
)

__all__ = [
    "ARRIVAL_KINDS",
    "SynthCorpus",
    "TraceQuery",
    "make_arrivals",
    "make_corpus",
    "make_mixture_trace",
    "make_query_trace",
    "make_uniform_trace",
    "make_zipf_trace",
    "pad_trace_batch",
    "stamp_arrivals",
    "term_document_frequencies",
]
