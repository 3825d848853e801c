"""What decides ``correct``: the served outputs held against the float32
reference, number by number, each against its limit.

For every position a served request was answered at, the reference's
logits say how far the token the program put first lies below the
reference's best: ``gap = max(ref) - ref[token]`` (0 where they agree).
A one-shot request is answered with its logits, so its token is their
argmax at every position; a decode stream is answered with tokens, each
judged at the position that produced it (the reference runs over the
prompt and the served tokens, teacher-forced). Compared:

``gap_max``   the widest gap over every checked position;
``gap_mean``  the mean gap over those positions;
``rel_rms``   (one-shot only) the served logits' RMS distance from the
              reference's, over the reference's RMS, all positions.

A request that was due and never answered also makes a run incorrect.
"""
from __future__ import annotations

import torch

NUMBERS = ("gap_max", "gap_mean", "rel_rms")


class Tally:
    """Accumulates the compared numbers over a run's sample."""

    def __init__(self):
        self.gap_max = 0.0
        self.gap_sum = 0.0
        self.n_pos = 0
        self.err2 = 0.0
        self.ref2 = 0.0

    def gaps(self, ref: torch.Tensor, picks: torch.Tensor) -> None:
        """ref (N, V) float32 logits, picks (N,) the tokens judged."""
        g = ref.max(dim=-1).values - ref.gather(
            -1, picks.long().view(-1, 1)).squeeze(-1)
        self.gap_max = max(self.gap_max, float(g.max()))
        self.gap_sum += float(g.double().sum())
        self.n_pos += int(g.numel())

    def logits(self, ref: torch.Tensor, got: torch.Tensor) -> None:
        """The whole served logits against the reference's."""
        got = got.to(ref.device, torch.float32)
        self.err2 += float(((got - ref) ** 2).double().sum())
        self.ref2 += float((ref ** 2).double().sum())
        self.gaps(ref, got.argmax(dim=-1))

    def numbers(self) -> dict:
        out = {"gap_max": self.gap_max,
               "gap_mean": self.gap_sum / max(self.n_pos, 1),
               "positions": self.n_pos}
        if self.ref2 > 0:
            out["rel_rms"] = (self.err2 / self.ref2) ** 0.5
        return out


def judge(numbers: dict, limits: dict, unanswered: int) -> tuple:
    """-> (correct, {name: {"value", "limit"}}) over the numbers the cell
    has limits for, plus the count of due requests never answered."""
    shown = {}
    ok = unanswered == 0
    for name in NUMBERS:
        if name not in limits or name not in numbers:
            continue
        v, lim = float(numbers[name]), float(limits[name])
        shown[name] = {"value": v, "limit": lim}
        ok = ok and v <= lim
    shown["unanswered"] = {"value": unanswered, "limit": 0}
    return ok, shown


def oneshot_sample(ref, reqs: list, device) -> Tally:
    """reqs: [(tokens, served logits)] -> the tally."""
    t = Tally()
    for toks, got in reqs:
        x = torch.as_tensor(toks, device=device)
        t.logits(ref.logits(x), got)
    return t


def decode_sample(ref, streams: list, device) -> Tally:
    """streams: [(prompt tokens, served tokens)] -> the tally, each
    served token judged at the position that produced it."""
    t = Tally()
    for prompt, out in streams:
        S = len(prompt)
        seq = torch.as_tensor(list(prompt) + list(out[:-1]),
                              dtype=torch.int32, device=device)
        logits = ref.logits(seq)[S - 1:]
        t.gaps(logits, torch.as_tensor(out, device=device))
    return t


def control_sample(ref, ctrl, seqs: list, device, *, n_prompt=None
                   ) -> tuple:
    """The control: at each judged position of ``seqs`` (token lists),
    the token the lower precision puts first, judged by the reference.
    ``n_prompt`` [int] marks where each sequence's judged positions
    start (None: every position). -> (control tally, the control's
    logits against the reference's tally)."""
    t = Tally()
    for i, seq in enumerate(seqs):
        x = torch.as_tensor(seq, dtype=torch.int32, device=device)
        r, c = ref.logits(x), ctrl.logits(x)
        if n_prompt is not None:
            r, c = r[n_prompt[i] - 1:], c[n_prompt[i] - 1:]
        if n_prompt is None:
            t.logits(r, c)
        else:
            t.gaps(r, c.argmax(dim=-1))
    return t
