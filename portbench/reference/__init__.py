"""The plain reference of the benchmark: routing, the summarizers and the
work counts, in plain PyTorch.  It imports nothing of the program under
test and takes nothing the program made: it works the inputs out again
from the configuration and the generated batches.

One module per algorithm (named by the configuration's ``reference``
key) gives ``OUTPUT_KEYS``, ``hyper``, ``run``, ``compare``, ``fresh``
and ``work``.
"""
