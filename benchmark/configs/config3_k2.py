"""The system of config3_k2, made once by `python benchmark/make_data.py
config3_k2`: BASELINE config 3 as bench.py builds it, on the port's own
builder (solvated polyalanine, 250 residues, OPC water, ~25,000 sites)."""


def build():
    from molchanica_tpu_torch.systems.bench_systems import \
        build_solvated_protein

    return build_solvated_protein(n_residues=250, target_sites=25000, seed=3)
