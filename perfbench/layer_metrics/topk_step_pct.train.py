"""Share (%) of the window's steps that took the render's top-K branch,
from the step's own branch counter (``make_train_step(...).branches``)."""


def read(record):
    b = record.get("branches")
    if not b or b["topk"] + b["full"] == 0:
        return None
    return 100.0 * b["topk"] / (b["topk"] + b["full"])
