"""``edge_stage_ms.<cell kind>``: the stream's edge stage busy seconds (the
program's ``StageStats.busy_s``) over the images it served, in ms."""


def read(rec):
    return rec.get("edge_stage_ms")
