"""CLI smoke tests: every subcommand runs end to end at reduced size."""

import json
import os

import numpy as np
import pytest

import nis_sar_amtigmti_video_tpu as nst
from nis_sar_amtigmti_video_tpu.cli import main


class TestFastCommands:
    def test_targets(self, tmp_path):
        main(["--out", str(tmp_path), "targets"])
        assert (tmp_path / "targets_preview.png").exists()

    @pytest.mark.parametrize("missing,dist", [("matplotlib", "matplotlib"),
                                              ("PIL", "Pillow")])
    def test_missing_render_dependency_is_named(self, tmp_path, monkeypatch,
                                                missing, dist):
        """Without a render dependency the CLI says which package is
        missing instead of failing deep inside the render step."""
        import sys
        for mod in [m for m in sys.modules
                    if m == missing or m.startswith(missing + ".")]:
            monkeypatch.delitem(sys.modules, mod)
        monkeypatch.setitem(sys.modules, missing, None)
        cmd = "targets" if missing == "matplotlib" else "videosar"
        extra = [] if cmd == "targets" else ["--frames", "1"]
        with pytest.raises(SystemExit) as exc:
            main(["--out", str(tmp_path), "--small", "--no-noise", cmd,
                  *extra])
        assert dist in str(exc.value) and "not installed" in str(exc.value)

    def test_world(self, tmp_path):
        main(["--out", str(tmp_path), "world"])
        for f in ("world.obj", "world.mtl", "world_preview.png",
                  "world_flythrough.gif"):
            assert (tmp_path / f).exists()

    def test_coverage_json(self, tmp_path, capsys):
        main(["--out", str(tmp_path), "coverage", "--sats", "12",
              "--duration", "1800", "--dt", "30"])
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["num_sats"] == 12
        assert 0.0 <= out["coverage_pct"] <= 100.0

    def test_timing_json(self, tmp_path, capsys):
        main(["--out", str(tmp_path), "timing", "--prf-min", "2000",
              "--prf-max", "4000"])
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["swath_far_km"] > out["swath_near_km"]
        assert len(out["clear_prf_bands_hz"]) > 0

    def test_budget_json(self, tmp_path, capsys):
        main(["--out", str(tmp_path), "budget", "--preset", "ati_dpca"])
        out = json.loads(capsys.readouterr().out.strip())
        assert out["scenario"] == "ati_dpca"

    def test_geometry(self, tmp_path):
        main(["--out", str(tmp_path), "geometry", "--preset", "videosar"])
        assert (tmp_path / "geometry_videosar.png").exists()


class TestPipelineCommands:
    def test_stripmap_and_view(self, tmp_path):
        main(["--out", str(tmp_path), "--small", "--no-noise", "stripmap"])
        npz = tmp_path / "sar_satellite_data.npz"
        assert npz.exists()
        z = np.load(npz)
        # reference viewer key contract (sar_satellite_sim.py:483-500)
        for k in ("raw_phist", "range_comp", "rd_map", "rd_rcmc",
                  "final_image", "range_axis", "cross_range", "doppler_axis",
                  "orbit_alt", "v_eff", "r0"):
            assert k in z, k
        # headless viewer renders it
        main(["--out", str(tmp_path), "view", str(npz)])
        assert (tmp_path / "sar_satellite_data_final_image.png").exists()

    def test_videosar_and_view_frames(self, tmp_path):
        main(["--out", str(tmp_path), "--small", "--no-noise", "videosar",
              "--frames", "2", "--algo", "stdbp"])
        frame_dir = tmp_path / "frames_Destroyer_15_0_stdbp"
        assert (frame_dir / "frame_00000.npy").exists()
        main(["--out", str(tmp_path), "view", str(frame_dir)])
        assert (tmp_path / "frames_Destroyer_15_0_stdbp.gif").exists()


class TestGlobalFlagPositions:
    """Global flags must work after the subcommand too — the --help examples
    show them there (e.g. "ati-dpca --small")."""

    def test_flags_after_subcommand(self, tmp_path, capsys):
        main(["budget", "--preset", "ati_dpca", "--out", str(tmp_path)])
        assert "snr_db_per_m2" in capsys.readouterr().out

    def test_targets_out_after_subcommand(self, tmp_path):
        main(["targets", "--out", str(tmp_path)])
        assert (tmp_path / "targets_preview.png").exists()

    def test_pre_subcommand_value_not_overwritten(self, tmp_path):
        # --out given BEFORE the subcommand must survive the subparser pass
        main(["--out", str(tmp_path), "targets"])
        assert (tmp_path / "targets_preview.png").exists()


class TestRemainingCommands:
    def test_videosar_batch_matrix(self, tmp_path):
        """The reference's batch matrix runner (sar_batch_sim.py:240-361):
        vehicles x headings x algos, per-cell frame dirs + GIFs."""
        main(["--small", "--fast-sim", "--no-noise", "--out", str(tmp_path),
              "videosar-batch", "--vehicles", "Destroyer",
              "--headings", "0,90", "--algos", "mbp,stdbp", "--frames", "2"])
        gifs = sorted(f.name for f in tmp_path.glob("*.gif"))
        assert gifs == ["Destroyer_15_0_mbp.gif", "Destroyer_15_0_stdbp.gif",
                        "Destroyer_15_90_mbp.gif", "Destroyer_15_90_stdbp.gif"]

    def test_ati_dpca_products(self, tmp_path):
        main(["--small", "--fast-sim", "--no-noise", "--out", str(tmp_path),
              "ati-dpca", "--clutter", "10"])
        assert (tmp_path / "sar_ati_dpca_data_csa.npz").exists()
        # the reference's three standalone plot filenames
        for n in ("csa_sar_ati_ch1_mag.png", "csa_sar_ati_phase.png",
                  "csa_sar_dpca_diff.png"):
            assert (tmp_path / n).exists()
