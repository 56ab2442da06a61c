"""runner_hit_share.session (ratio): the share of the profiled slice's
solves that reused a kept engine and its captured graphs: the program's
``solve`` spans whose ``engine_cache`` reads "hit", over those that read
"hit" or "miss" (a "bypass", such as a banded BA, counts in neither).
Nothing where no span carries the attribute."""
from portbench import spans, stats


def read(run):
    cached = [r["attrs"].get("engine_cache")
              for r in spans.named(spans.records(), "solve")]
    hits = cached.count("hit")
    return stats.per_item(hits, hits + cached.count("miss"))
