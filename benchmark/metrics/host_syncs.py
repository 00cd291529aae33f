"""Host-device synchronisations a step or a batch: the cudaStreamSynchronize,
cudaDeviceSynchronize and cudaEventSynchronize calls inside the root span
(`rpc.train_step`, `rpc.serve`), in the traced steps. Each empties the
device's queue, so the card goes idle."""
from benchmark import spans


def read(ctx):
    return spans.host_syncs(ctx)
