"""PyTorch/CUDA port of ``repro`` for NVIDIA Hopper (H100, sm_90a).

The package mirrors ``repro``'s layout and names.  It imports torch and
numpy and nothing of ``repro``: the numpy compiler modules are its own copies.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``, and
raise when ``cuda`` is asked for and no card is present.
"""
