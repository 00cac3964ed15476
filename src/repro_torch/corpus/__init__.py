from repro_torch.corpus.synth import (
    SynthCorpus,
    TraceQuery,
    make_corpus,
    make_query_trace,
    make_zipf_trace,
    pad_trace_batch,
)

__all__ = [
    "SynthCorpus",
    "TraceQuery",
    "make_corpus",
    "make_query_trace",
    "make_zipf_trace",
    "pad_trace_batch",
]
