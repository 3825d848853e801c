"""Data pipelines of the port: bandwidth traces for the serving path and
the synthetic token stream for training."""
from repro_torch.data.traces import BandwidthTrace, synth_5g_trace
from repro_torch.data.tokens import token_batches

__all__ = ["BandwidthTrace", "synth_5g_trace", "token_batches"]
