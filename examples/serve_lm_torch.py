"""Serve a zoo model with batched requests (prefill + greedy decode loop).

The PyTorch/CUDA twin of ``examples/serve_lm.py``: the same defaults
(reduced chatglm3-6b, 8 requests in batches of 4, 16-token prompts, 8 new
tokens), through ``repro_torch.launch.serve``, on the CUDA device unless
``--device`` names another.

    PYTHONPATH=src python examples/serve_lm_torch.py                 # on the CUDA device
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu
"""

import sys

from repro_torch.launch import serve

if __name__ == "__main__":
    argv = sys.argv[1:]
    if not any(a.startswith("--arch") for a in argv):
        argv = ["--arch", "chatglm3-6b", "--reduced", "--requests", "8",
                "--batch", "4", "--prompt-len", "16", "--max-new", "8"] + argv
    serve.main(argv)
