"""Requests per pool batch: the ``n_batch`` of the pools' ``exec``
spans over the traced window."""


def read(ctx):
    ns = [s["args"].get("n_batch", 0) for s in ctx.get("spans", [])
          if s["name"] == "exec"]
    return sum(ns) / len(ns) if ns else None
