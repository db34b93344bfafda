"""Host time of tokenize + pack + enqueue of one retrieval batch:
``FusedRetrievalPipeline.report()["tokenize+pack+dispatch"]`` mean over
the window (the stage never waits for the device: host time only)."""


def read(run):
    stage = run.facts.get("report", {}).get("tokenize+pack+dispatch")
    if not stage or not stage["count"]:
        return None
    return 1e3 * stage["total_s"] / stage["count"]
