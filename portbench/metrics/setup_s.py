"""Seconds from the start of the run's process to the opening of the
window: tables made, catalog built, service up, the mix's shapes warmed."""


def read(run):
    return run.setup_s
