"""The benchmark's machinery: traffic, weights, taps, traces, checks."""
