"""The benchmark's yardstick: peaks, counts, traffic sources, traces."""
