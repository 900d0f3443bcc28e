"""Batched serving on the PyTorch/CUDA port: prefill + decode with KV
caches over a request queue, on a reduced config of an assigned
architecture (the port of ``examples/serve_lm.py``; the options are
``repro_torch.launch.serve.main``'s, ``--device cpu`` among them).

  PYTHONPATH=src python examples/torch/serve_lm.py --arch hymba-1.5b
  PYTHONPATH=src python examples/torch/serve_lm.py --arch mamba2-130m --requests 8
  PYTHONPATH=src python examples/torch/serve_lm.py --device cpu
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

from repro_torch.launch.serve import main as serve_main

if __name__ == "__main__":
    serve_main()
