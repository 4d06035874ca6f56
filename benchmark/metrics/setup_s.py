"""Seconds from the process's start to the first timed step or request:
imports, kernel builds (the first run in a checkout), weights and inputs,
the verified steps or the export and load, and warm-up."""


def read(record):
  return record.setup_s
