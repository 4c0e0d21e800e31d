"""Device operations a traced optimizer step."""


def read(ctx):
    if not ctx.get("steps"):
        return None
    return ctx["trace"].kernel_count() / ctx["steps"]
