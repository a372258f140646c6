"""`rows_per_branch.render`: the rows handed to a frame's human branches
(the counter `render.branch_rays`) over the calls of the span
`render.human_branch`: how many rows a branch call takes
(benchmark/program_spans.py). None without the counter or the span."""

from benchmark import program_spans


def read(ctx):
    snap = program_spans.snapshot() if ctx.unit == "frame" else None
    rows = (snap or {}).get("counters", {}).get("render.branch_rays")
    calls = (snap or {}).get("spans", {}).get("render.human_branch", {}).get("calls")
    if rows is None or not calls:
        return None
    return rows / calls
