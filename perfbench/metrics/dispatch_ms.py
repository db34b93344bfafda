"""Mean host wall of one dispatch of the online service, from the
harness's wrapper of the pipeline it hands the service (the results end on
the host, so the time covers the device work)."""


def read(run):
    spans = run.facts.get("dispatch_s")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
