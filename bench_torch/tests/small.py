"""Each cell cut to a size the CPU runs in a second: a coarse grid, few
observations, members and analyses. Only the sizes change; the cell's
code, references and limits are those of the card."""

# the clip's first block sized against the rank it keeps as at full size,
# so that its pairs converge, or fail to, as they do there: a little
# wider than the months' rank (614 of the 6-degree grid's 1,800 cells;
# 835 in 1,024 at 1 degree), narrower than the longest variant's, which
# widens past it (697 past 512; 1,230 past 1,024)
CLIP = {"k0": 768, "max_rank": 1024, "rank_multiple": 16}
VARIANT_CLIP = {**CLIP, "k0": 512}

SMALL = {
    "st1deg.analysis": {
        "config": {"grid": {"step_deg": 10.0}},
        "mix": {"pool": 4, "laws": {"m": {"low": 20, "high": 80}}}},
    "st1deg.ensemble": {
        "config": {"grid": {"step_deg": 10.0}, "members": 8},
        "mix": {"pool": 4, "laws": {"m": {"low": 20, "high": 80}}}},
    "ell1deg.months": {
        "config": {"grid": {"step_deg": 6.0}, "members": 8, "pad_rank": 32,
                   "clip": CLIP},
        "mix": {"pool": 4, "laws": {"m": {"low": 20, "high": 80}}}},
    "ell1deg.variants": {
        "config": {"grid": {"step_deg": 6.0}, "members": 8, "pad_rank": 32,
                   "clip": VARIANT_CLIP},
        "mix": {"pool": 2, "observations": 60, "compare": 2}},
}


# long enough that the window reaches every analysis of the pool
SECONDS = {"ell1deg.variants": 1.5}


def run_small(harness, name, seed=20240101, seconds=None, control=False,
              bench=None, root=None, traced=False):
    """One run of cell `name`, cut to SMALL, on the CPU; the result
    line's dict."""
    import time

    if seconds is None:
        seconds = SECONDS.get(name, 0.2)

    kw = {} if root is None else {"root": root}
    cell = harness.find_cell(name, bench=bench, overrides=SMALL[name], **kw)
    return harness.run(cell, seed, seconds, traced, "cpu", time.perf_counter(),
                       control=control, need_card=False,
                       log=lambda *a, **k: None)
