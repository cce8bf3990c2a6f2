# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""repro_torch.ingest — the streaming front end of the SummarizerPod
(port of ``repro/ingest``).

Sources produce tagged host batches, the bounded TaggedBuffer absorbs
rate mismatch under an explicit backpressure policy (plus optional
per-session token-bucket rate limits and the watermark shedding ladder,
``repro_torch.ingest.shedding``), and IngestPipeline double-buffers the
staging of the next batch against the card's step:

    Source -> TaggedBuffer -> pinned copy -> route -> ingest_routed
    (producer threads)        (overlapped with the running pod step)

(a pod on the CPU takes ``host_route`` in place of the copy and the
card's route).

Above that sits the fleet edge: ``PodRouter`` fans one tagged ingress
across pods, and ``repro_torch.ingest.pubsub`` puts a partitioned,
offset-addressed log (broker + wire protocol + front end) between
untrusted producers and the router, with exactly-once producer resume
and offset commits at the pipeline's sync boundary.
"""
from .buffer import PAD_SID, POLICIES, TaggedBuffer
from .pipeline import IngestPipeline, PodRouter, host_route
from .pubsub import (Publisher, PubSubBroker, PubSubFrontEnd, PubSubListener,
                     partition_of, publish_frame)
from .shedding import RUNGS, RateLimit, ShedPolicy, TokenBucket
from .sources import (MAGIC, DriftSource, ReplaySource, SocketSource, Source,
                      SubsampleSource, TaggedBatch, connect_producer,
                      send_frame)

__all__ = ["PAD_SID", "POLICIES", "TaggedBuffer", "IngestPipeline",
           "PodRouter", "host_route", "MAGIC", "DriftSource",
           "ReplaySource", "SocketSource", "Source", "SubsampleSource",
           "TaggedBatch", "connect_producer", "send_frame",
           "Publisher", "PubSubBroker", "PubSubFrontEnd", "PubSubListener",
           "partition_of", "publish_frame",
           "RUNGS", "RateLimit", "ShedPolicy", "TokenBucket"]
