"""Reader loss and host-side QA metrics."""
