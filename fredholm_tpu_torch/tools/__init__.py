"""Measurement tools of the port (port of the reference's tools/ that
reach a kernel): probe_bf16, the card's FMA and memory-stream rates."""
