"""The system of config5_duplex, made once by `python benchmark/make_data.py
config5_duplex`: BASELINE config 5's farm system as scripts/bench_all.py
builds it, on the port's modules (the B-DNA duplex GATTACAGATT, centred in
a 46 A cube of OPC water, neutralized)."""


def build():
    import numpy as np

    from molchanica_tpu_torch.molecules.nucleic_acid import \
        MoleculeNucleicAcid
    from molchanica_tpu_torch.molecules.spec import assemble_system
    from molchanica_tpu_torch.systems.water import OPC

    na = MoleculeNucleicAcid.from_seq("GATTACAGATT", double=True)
    spec = na.to_spec()
    box = np.array([46.0] * 3)
    spec = spec.translated(box / 2 - np.asarray(spec.positions).mean(0))
    return assemble_system([spec], box_extent=box, water_model=OPC,
                           neutralize=True, seed=2)
