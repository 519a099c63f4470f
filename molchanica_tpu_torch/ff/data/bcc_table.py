"""BCC bond-charge-correction table — GENERATED by
scripts/fit_bcc.py (ridge LSQ of Gasteiger-base residuals
against the embedded published Amber ff14SB residue
charges). Units: electrons. Do not edit by hand.

Copy of molchanica_tpu.ff.data.bcc_table: the same table.
"""

BCC_TABLE = {
    (11, 12): +0.00527,
    (11, 15): -0.09195,
    (11, 23): -0.01181,
    (11, 26): -0.02645,
    (11, 31): +0.19618,
    (11, 41): +0.03111,
    (11, 91): -0.02291,
    (12, 22): +0.03551,
    (12, 23): +0.19759,
    (12, 31): +0.15813,
    (12, 91): -0.11146,
    (15, 23): +0.20346,
    (15, 32): +0.28671,
    (15, 33): +0.28480,
    (22, 92): -0.02755,
    (23, 92): -0.18899,
    (26, 92): -0.01232,
    (31, 93): -0.13182,
    (41, 94): -0.09744,
}
