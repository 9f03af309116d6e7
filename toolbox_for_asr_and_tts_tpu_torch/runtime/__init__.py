"""Framework-free runtime pieces of the port: shape bucketing, RTF
metrics, the voice service's config, the Prometheus and model registries."""
