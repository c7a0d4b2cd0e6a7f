"""SkipGram negative sampling of the port: corpus, model and trainer."""
