"""The accuracy harness of the port (the counterpart of the JAX
package's tools/rmse_*.py): for each BASELINE configuration it renders,
on the card unless the caller asks for the CPU,

1. the full-resolution same-seed image at the harness spp, held against
   the JAX package's CPU render of the same seed (out/rmse/
   {cfg}_cpu_sameseed*.npy) under the independent-render floor;
2. the proxy-resolution mean and variance at PROXY_SPP, held against the
   independent numpy oracle (out/rmse/{cfg}_oracle*) under the
   Monte-Carlo noise floor;
3. independent proxy draws (the empirical image-mean noise of the
   card's side, for the two-sample mean test),

then the report (report.py) with the JAX repo's gates unchanged.

    python -m raytracer_odin_tpu_torch.accuracy [cfg ...] [--part all]

configs.py says what each gate means; render.py renders the halves and
report.py combines them.
"""
