"""setup_s: seconds from the process's start to the window's first call
(host clock): imports, weights, inputs, the program's build and warm-up."""


def read(rec: dict, name: str) -> float:
    return rec["setup_s"]
