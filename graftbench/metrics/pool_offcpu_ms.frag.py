"""Mean time a pool batch's thread was not running: over the ``exec``
spans, the wall less ``cpu_ms`` (the thread's CPU time across the
span). That is the wait for the interpreter lock, or a blocking wait.
A CUDA wait that spins counts as CPU time, so it is not in here, and a
cut in the batch's host dispatch does not raise this."""


def read(ctx):
    xs = [s["dur_ms"] - s["args"]["cpu_ms"] for s in ctx.get("spans", [])
          if s["name"] == "exec" and "cpu_ms" in s["args"]]
    return sum(xs) / len(xs) if xs else None
