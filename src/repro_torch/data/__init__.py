"""Data helpers of the port: the byte tokenizer and the synthetic data
pipeline with the image / audio input stubs."""
