"""Data pipelines of the port: the CEP stream generators."""
