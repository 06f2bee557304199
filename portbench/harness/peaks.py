"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W
limit).  A card set to a lower power limit runs below them; every run
prints the card's limit beside the shares it reports."""

H100 = {
    "bf16_flops_per_s": 989e12,   # tensor cores, dense
    "hbm_bytes_per_s": 3.35e12,
}
