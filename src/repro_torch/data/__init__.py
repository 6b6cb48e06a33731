"""Data pipelines of the port: the CEP stream generators and the
synthetic LM batches."""
