"""Language branch of the port: phrase embeddings and the detection provider."""
