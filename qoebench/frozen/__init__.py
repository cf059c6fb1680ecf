"""The benchmark's own copies of the yardstick: QoE arithmetic, traffic
generators, the H100's published peaks, the FLOP and byte counts of a
step and of each attention kernel, and the KV-pool rule. Later changes to
the program leave these untouched, so a gain cannot come from a changed
ruler."""
