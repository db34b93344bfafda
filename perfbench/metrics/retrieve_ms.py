"""Wall of the retrieval stage of one ``AnswerPipeline.run`` call:
``report()["retrieve"]`` mean over the window (it ends in host arrays, so
the time covers the device work)."""


def read(run):
    stage = run.facts.get("report", {}).get("retrieve")
    if not stage or not stage["count"]:
        return None
    return 1e3 * stage["total_s"] / stage["count"]
