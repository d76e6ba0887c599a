"""The examples of the port, one module each, run as

    PYTHONPATH=src python -m repro_torch.examples.<name> [--device cpu]

* ``kraken_paper`` -- the paper's results: the uniform dataflow on a conv
  layer, a matrix product as a degenerate conv, elastic grouping, and
  Tables V and VI from the performance model (host numpy);
* ``quickstart`` -- smoke yi-6b: a forward and its loss, three AdamW steps,
  a prefill and eight greedy decode steps;
* ``long_context`` -- rwkv6-3b, zamba2-1.2b and mixtral-8x22b decoding far
  past a 32-entry cache (the recurrent state or the window's ring carries
  the context);
* ``serve_lm`` -- a smoke model through the serving engine;
* ``train_lm`` -- a ~100M-parameter yi-family model trained for 300 steps
  through the training launcher.

Each runs on ``--device`` (default ``cuda``; asking for CUDA without a
device raises) and exposes a function that takes its own model and
parameters.
"""
