"""The window's seconds over the decode iterations the engine committed in
it (``engine.iterations``)."""
NAME = "decode_iter_ms"
UNIT = "ms"
LAYER = "engine loop (serving/engine.py)"


def read(record):
    if not record.get("iterations"):
        return None
    return record["seconds"] / record["iterations"] * 1e3
