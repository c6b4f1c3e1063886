"""train_tokens_per_s: B*T tokens of every step of the window over its seconds
(the window closes at the end of the first step at or past its length)."""


def read(record, ctx):
    if not record.get("step_ends"):
        return None
    return len(record["step_ends"]) * record["tokens_per_step"] / record["window_s"]
