"""The mean ``optim.loss_readback`` span of the traced steps, ms: the loss
read to the host, where a step waits for the card to finish its work."""

from harness import spans


def read(ctx):
    return spans.mean_ms(ctx, "optim.loss_readback")
