"""Forward-model oracle CLI, flag-compatible with the reference TestModel.py.

Builds a model directly from an ms command string (trueEPS), prints the
expected JSFS and data llh, the saturated-model llh, optional bootstrap llh
confidence intervals, then runs the forward coalescent-rate direction and
writes a .mi file.  (The reference's bootstrap CI loop references an
undefined variable, TestModel.py:112; here, as in the JAX package, it
evaluates the base llh on each resampled spectrum, its evident intent.)
Runs in float64; ``--platform`` defaults to ``cuda`` and raises without a
card.
"""

from __future__ import annotations

import argparse
import math
import sys


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Migration inference from PSMC.")
    p.add_argument("msstring", help="ms style command")
    p.add_argument("fjafs", nargs="?", default="",
                   help="joint allele frequency spectrum file")
    p.add_argument("--funits", type=str, default="setunits.txt",
                   help="units file for time/EPS rescaling")
    p.add_argument("-uf", action="store_true", help="unfolded spectrum")
    p.add_argument("--bsSize", "-bs", type=int, default=0,
                   help="number of bootstrap repetitions")
    p.add_argument("-o", "--fout", default="", help="output file, default stdout")
    p.add_argument("--debug", action="store_true", help="debug mode")
    p.add_argument("--platform", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default; raises without a card) or cpu; float64 on both")
    return p


def main(argv=None) -> int:
    clargs = make_parser().parse_args(argv)

    import numpy as np
    import torch

    from ..config import resolve_device
    from ..engine.forward import coalescent_rates
    from ..engine.likelihood import build_likelihood
    from ..engine.spec import build_spec, saturated_llh
    from ..io import jsfs as io_jsfs
    from ..io import mi_format
    from ..io import ms_parse
    from ..io.units import Units

    device = resolve_device(clargs.platform)  # raises for cuda without a card
    dtype = torch.float64

    Units.set_units_from_file(clargs.funits)
    Units.print_units()

    jafs_input = clargs.fjafs != ""
    if not jafs_input:
        input_sfs = [1.0] * 8
        data_jafs = None
    else:
        data_jafs = io_jsfs.read_jafs(clargs.fjafs)
        input_sfs = list(data_jafs.summed())

    input_data = ms_parse.read_ms(clargs.msstring)

    def build(sfs8):
        return build_likelihood(
            build_spec(
                input_data.times, input_data.lambdas, sfs8,
                input_data.divergence_time, input_data.mi, input_data.pu,
                correct=False, unfolded=clargs.uf,
            ),
            device=device, dtype=dtype,
        )

    lik = build(input_sfs)
    llh, aux = lik.llh_aux(np.zeros(0))
    print("Expected SFS", [float(v) for v in aux["jafs"].tolist()])
    if jafs_input:
        jafs = np.asarray(input_sfs[1:], float)
        jafs = jafs / jafs.sum()
        print("Data     SFS", list(jafs))
        print("data llh under the model is", float(llh))
        print("maximum of the llh function is", saturated_llh(lik.spec))
        if clargs.bsSize > 1:
            bs_llh = sorted(
                float(build(io_jsfs.bootstrap_jafs(data_jafs)).llh(np.zeros(0)))
                for _ in range(clargs.bsSize)
            )
            cutoff = math.ceil(0.05 * clargs.bsSize)
            print("10% confidence interval", bs_llh[cutoff], bs_llh[-cutoff])
            cutoff = math.ceil(0.025 * clargs.bsSize)
            print("5% confidence interval", bs_llh[cutoff], bs_llh[-cutoff])

    # forward direction: true EPS -> mixed PSMC-style rates, for the .mi file
    lh_mixed, pr = coalescent_rates(lik.spec, aux["mi"], aux["pu"], device=device,
                                    dtype=dtype)
    if clargs.fout != "":
        text = mi_format.format_migration(
            llh=float(llh), split_t=lik.spec.splitT,
            sample_date=lik.spec.sample_date, thrh=lik.spec.thrh,
            jafs=aux["jafs"].cpu().numpy(), data_jafs=lik.spec.data_jafs,
            times=lik.spec.times, lc=aux["lc"].cpu().numpy(), lh=lh_mixed,
            mi=aux["mi"].cpu().numpy(), pr=pr, scale_time=2 * Units.n0,
        )
        mi_format.write_migration(clargs.fout, text)
    return 1  # reference exits 1 here (TestModel.py:127)


if __name__ == "__main__":
    sys.exit(main())
