"""``publish_ms``: the harness's host clock around one bulk of mutations
(``SearchService.insert/delete/update``), the writer's publish
(``DeltaWriter.device_delta()``) and a synchronize, averaged over the
window's bulks.  Merge-on-read cells only."""


def read(run):
    if not run.merge_on_read or not run.publish_s:
        return None
    return 1e3 * sum(run.publish_s) / len(run.publish_s)
