"""Host wall of the collator a training step: ``BiEncoderCollator``'s
tokenization and packing of one batch, timed by the harness around the
call inside the window (the host's share of a step that the device may
wait for)."""


def read(run):
    spans = run.facts.get("collate_s")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
