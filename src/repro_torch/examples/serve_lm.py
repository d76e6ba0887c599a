"""Serve a small model through the serving engine (the per-layer state
tree: paged KV pools + recurrent slot rows, chunked-prefill continuous
batching, FIFO admission).

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch mixtral-8x22b  # MoE+SWA
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch rwkv6-3b       # RWKV
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch zamba2-1.2b    # hybrid
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --chunk 8             # stream
                                               # prompts 8 tokens per step

Every registry architecture serves through the same engine.  Prompts
stream in through fixed-size chunks fused with the batched decode step
(``max decode stall=0``: no decode slot ever waits on a prompt);
``--repeat 2`` shows that the warm engine adds no program signature on the
second pass.  Any other flag of ``repro_torch.launch.serve`` passes
through (``--device``, default ``cuda``).
"""

from __future__ import annotations

import sys

from repro_torch.launch import serve


def main(argv=None) -> int:
    argv = list(argv) if argv is not None else sys.argv[1:]
    if not any(a.startswith("--arch") for a in argv):
        argv = ["--arch", "yi-6b"] + argv
    return serve.main(argv + ["--smoke", "--requests", "6", "--slots", "3",
                              "--prompt-lens", "5,9,12", "--max-new", "12",
                              "--cache-len", "64", "--page-size", "8"])


if __name__ == "__main__":
    sys.exit(main())
