"""The whole step's share (%) of the card's peak: the step's counted FLOPs
(``counts.train_step_flops``) over the window's seconds a step times the
peak of the compute dtype."""


def read(record):
    if not record.get("peak_flops"):
        return None
    return (100.0 * record["flops_per_step"]
            / (record["step_s"] * record["peak_flops"]))
