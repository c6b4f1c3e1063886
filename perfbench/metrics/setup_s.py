"""setup_s: seconds from the process's start to the first timed step."""


def read(record, ctx):
    return record["setup_s"]
