"""Set-up: process start to the first timed batch or call (the model
built, weights made on the card, inputs made, the cell's shapes warmed up)."""


def read(run):
    return run.setup_s
