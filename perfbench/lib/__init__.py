"""The benchmark's yardstick: seeded inputs, FLOP and byte counts, the trace
reader, the comparison that decides `correct`."""
