"""Measurement probes of the port's kernels; run on the card, by hand."""
