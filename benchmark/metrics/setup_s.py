"""setup_s: process start to the first timed call (host clock): imports,
the program's kernel libraries (built into the checkout on the first run
only), the inputs generated and written, and one warm-up call."""


def read(run: dict) -> "float | None":
    return run["setup_s"]
