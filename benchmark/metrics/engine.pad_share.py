"""Share of the pair-sites the engine launched that were padding: 100 x
(1 - real / launched) over the traced window's ``engine.batch`` spans,
whose ``real_pair_sites`` count each alignment's C(n, 2) x L and whose
``padded_pair_sites`` count the batch's rows x C(pad_n, 2) x pad_l."""

from benchmark import program_spans


def read(r):
    return value(program_spans.recording())


def value(rec):
    batches = program_spans.named(rec, "engine.batch")
    padded = sum(s.attrs["padded_pair_sites"] for s in batches)
    if not padded:
        return None
    real = sum(s.attrs["real_pair_sites"] for s in batches)
    return 100.0 * (1.0 - real / padded)
