"""Share of the pool's decode steps whose model step replayed a CUDA
graph: the ``decode/step/forward`` spans whose ``graph`` arg is true,
over those that carry the arg, x 100. A program whose forward spans
carry no such arg reads nothing."""


def read(ctx):
    gs = [s["args"]["graph"] for s in ctx.get("spans", [])
          if s["name"] == "decode/step/forward"
          and "graph" in (s.get("args") or {})]
    return 100.0 * sum(map(bool, gs)) / len(gs) if gs else None
