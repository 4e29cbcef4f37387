"""setup_s (s): from the start of the process to the start of the window:
imports, the CUDA context, the kernel library's build or load, the
sequence's render, and the warm-up through the first local
BA."""


def read(rec: dict):
    return rec["setup_s"]
