"""OUTPUT_SHARDS in the port (vic_tpu_torch/parallel/io_shards.py,
tools/merge_output_shards_torch.py) against vic_tpu's
(vic_tpu/parallel/io_shards.py): the shards' cell ranges, the shard files
and their merge, equal file for file (read with the port's NetCDFFile); and
a driver run with OUTPUT_SHARDS 3 whose merged shards equal the one file a
single writer makes of the same outputs.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_state_netcdf import assert_files_equal, read_all

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("n_cell,n_shards", [(10, 3), (8, 8), (7, 3),
                                             (7, 1), (5, 8), (1, 2),
                                             (16, 5), (32768, 3)])
def test_shard_ranges_match_vic_tpu(n_cell, n_shards):
    from vic_tpu.parallel.io_shards import shard_ranges as jranges
    from vic_tpu_torch.parallel.io_shards import shard_ranges
    got = shard_ranges(n_cell, n_shards)
    assert got == jranges(n_cell, n_shards)
    assert got[0][0] == 0 and got[-1][1] == n_cell
    assert all(a[1] == b[0] for a, b in zip(got, got[1:]))


def seeded_outputs(n_t, n_cell, nl=3):
    rng = np.random.default_rng(4)
    return {
        "OUT_EVAP": rng.uniform(0, 5, (n_t, n_cell)),
        "OUT_RUNOFF": rng.uniform(0, 8, (n_t, n_cell)),
        "OUT_SOIL_MOIST": rng.uniform(10, 300, (n_t, n_cell, nl)),
        "OUT_SWE_BAND": rng.uniform(0, 90, (n_t, n_cell, 2)),
        "OUT_FDEPTH": rng.uniform(0, 50, (n_t, n_cell, 3)),
    }


def test_shard_files_and_merge_match_vic_tpu(tmp_path):
    from vic_tpu.parallel import io_shards as jshards
    from vic_tpu_torch.output import NetCDFOutputWriter
    from vic_tpu_torch.parallel import io_shards
    n_t, n_cell = 6, 7
    lats = 45.0 + 0.25 * np.arange(n_cell)
    lons = -120.0 + 0.25 * (np.arange(n_cell) % 3)
    agg = seeded_outputs(n_t, n_cell)
    tvals = np.arange(n_t, dtype=float)
    kw = dict(nlayer=3, nnode=3, nband=2, global_attrs={"source": "test"})
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jbase, tbase = str(tmp_path / "j" / "out.nc"), str(tmp_path / "t" /
                                                       "out.nc")
    jpaths = jshards.write_sharded_netcdf(jbase, lats, lons, agg, tvals, 3,
                                          **kw)
    tpaths = io_shards.write_sharded_netcdf(tbase, lats, lons, agg, tvals,
                                            3, **kw)
    assert [os.path.basename(p) for p in tpaths] == \
        [os.path.basename(p) for p in jpaths] == \
        [f"out.shard{i}of3.nc" for i in range(3)]
    assert io_shards.find_shards(tbase) == tpaths
    for a, b in zip(jpaths, tpaths):
        assert_files_equal(a, b)
    # a process of two writes its own blocks: 0 -> shards 0, 1; 1 -> 2
    owned = io_shards.write_sharded_netcdf(
        str(tmp_path / "p.nc"), lats, lons, agg, tvals, 3, **kw,
        process_index=1, process_count=2)
    assert [os.path.basename(p) for p in owned] == ["p.shard2of3.nc"]

    # vic_tpu's merge reads an output over the frost fronts (OUT_FDEPTH)
    # as if it had no such axis and fails; the port's takes the front
    # dimension: compared without it, then held alone with it
    with pytest.raises(OSError, match="exceeds dimension bound"):
        jshards.merge_shards(jbase)
    no_front = {k: v for k, v in agg.items() if k != "OUT_FDEPTH"}
    for base, shards in ((jbase, jshards), (tbase, io_shards)):
        shards.write_sharded_netcdf(base, lats, lons, no_front, tvals, 3,
                                    **kw)
    jmerged = jshards.merge_shards(jbase)
    tmerged = io_shards.merge_shards(tbase, str(tmp_path / "merged.nc"))
    assert_files_equal(jmerged, tmerged)
    io_shards.write_sharded_netcdf(tbase, lats, lons, agg, tvals, 3, **kw)
    tmerged = io_shards.merge_shards(tbase, str(tmp_path / "merged.nc"))
    one = str(tmp_path / "one.nc")
    w = NetCDFOutputWriter(one, lats, lons, list(agg), nlayer=3, nnode=3,
                           nband=2)
    w.write_all(agg, tvals)
    w.close()
    assert "FDEPTH" in read_all(tmerged)
    assert_files_equal(one, tmerged)


def test_driver_writes_shards_that_merge_to_the_single_file(tmp_path):
    """A 7-cell run of the main path with NETCDF output in 3 shards; the
    merge tool gathers them onto the file the single writer makes of the
    same outputs."""
    from vic_tpu_torch import config, driver
    from vic_tpu_torch.testing import write_driver_run
    gfile = write_driver_run(tmp_path / "run", 7, start=(1995, 9, 25),
                             n_day=6, accum_start=(1994, 10, 1),
                             july_tavg=(6.0, 16.0), output_format="NETCDF")
    gp = config.parse_global_param_file(gfile).replace(output_shards=3)
    res = driver.run_simulation(gp, progress=False, device="cpu")
    base = os.path.join(gp.result_dir, gp.netcdf_output_filename)
    shards = sorted(f for f in os.listdir(gp.result_dir) if ".shard" in f)
    root, ext = os.path.splitext(os.path.basename(base))
    assert shards == [f"{root}.shard{i}of3{ext}" for i in range(3)]
    assert not os.path.exists(base)
    merged = str(tmp_path / "merged.nc")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools",
                                      "merge_output_shards_torch.py"),
         base, "-o", merged], env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == f"merged -> {merged}"
    steps = max(1, gp.out_step // gp.dt)
    single = gp.replace(output_shards=1,
                        netcdf_output_filename="single.nc")
    driver.write_outputs(single, driver.load_domain(gp), res.timeaxis,
                         res.outputs, steps)
    one = read_all(os.path.join(gp.result_dir, "single.nc"))
    got = read_all(merged)
    assert list(got) == list(one)
    for name in one:
        if name != "__global__":
            assert got[name][:4] == one[name][:4], name
            np.testing.assert_array_equal(got[name][4], one[name][4],
                                          err_msg=name)
    n_out = len(res.outputs["OUT_WATER_ERROR"])
    assert got["time"][2] == [n_out] and n_out == 6
