"""setup_s: from the process's start to the window's: imports, the data made
from the seed, the index's build, the kernels' build and load, the warm-up."""
UNIT = "s"


def read(rec):
    return rec["setup_s"]
