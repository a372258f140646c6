"""`placeholder_pct.render`: the share of the rows handed to the actors'
human branches that carry placeholders, the rows of an actor that its own
hit test misses: 100 x (1 - `render.actor_rays` / `render.branch_rays`)
(benchmark/program_spans.py). None without both counters."""

from benchmark import program_spans


def read(ctx):
    actor = program_spans.counter(ctx, "frame", "render.actor_rays")
    branch = program_spans.counter(ctx, "frame", "render.branch_rays")
    if actor is None or not branch:
        return None
    return 100.0 * (1.0 - actor / branch)
