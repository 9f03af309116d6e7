"""Framework-free runtime pieces of the port: shape bucketing and RTF
metrics."""
