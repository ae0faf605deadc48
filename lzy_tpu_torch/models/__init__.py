"""Model definitions (Llama) and the generate() oracle."""
