"""Host time to frame a pool batch's reply (the logits, copied from the
device and packed) plus the time to unpack it on the server's side: the
mean ``frame/encode`` and the mean ``frame/decode`` span of the reply
frames of ``flush`` and ``execute`` hops."""


def _mean(xs):
    return sum(xs) / len(xs) if xs else None


def read(ctx):
    by = {"frame/encode": [], "frame/decode": []}
    for s in ctx.get("spans", []):
        a = s["args"]
        if s["name"] in by and a.get("dir") == "reply" \
                and a.get("op") in ("flush", "execute"):
            by[s["name"]].append(s["dur_ms"])
    enc, dec = _mean(by["frame/encode"]), _mean(by["frame/decode"])
    return None if enc is None or dec is None else enc + dec
