"""Query embedding and the streaming retrieval pipeline."""
