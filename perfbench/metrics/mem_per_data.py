"""The run's peak of device memory allocated (``torch.cuda.
max_memory_allocated`` from the program's set-up to the window's end) over
the bytes of the table's values as the configuration defines them: records
x attributes x bytes a value."""


def read(rec):
    data = rec.n_records * rec.attributes * rec.value_bytes
    if not rec.memory_peak_bytes or not data:
        return None
    return rec.memory_peak_bytes / data
