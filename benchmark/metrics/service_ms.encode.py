"""The service's own time per image, in ms: each image's request wall
(single-image: from the bus request to its object landing) or its
``batch.item`` span (CSV), less the ``convert.encode`` span of the same
image id; the mean over the images."""


def read(run):
    inner = {}
    for s in run.spans:
        if s["name"] == "convert.encode":
            key = s["attrs"].get("image_id")
            inner[key] = inner.get(key, 0.0) + s["dur"]
    outer = {s["attrs"].get("image_id"): s["dur"] for s in run.spans
             if s["name"] == "batch.item"}
    for op in run.window.ops:
        if "image_id" in op:
            outer[op["image_id"]] = op["end"] - op["start"]
    both = [outer[k] - inner[k] for k in outer if k in inner]
    return 1000.0 * sum(both) / len(both) if both else None
