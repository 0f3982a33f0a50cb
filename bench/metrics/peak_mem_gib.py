"""The card's peak allocated memory over set-up and window
(``torch.cuda.max_memory_allocated``), the fullest worker's."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
