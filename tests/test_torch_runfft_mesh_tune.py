"""The port's run-fft driver on a 4-rank gloo world on 2 x 2 under
``torchrun``, ``--device cpu``: the reference's tests/test_cli.py xla
sharded cross-check (here ``-a torch``: an x-slab distributed fftn of
torch.fft and one all_to_all, ``fftn@mesh``) and its tuning smoke run on
the mesh (a tiny budget, the plan cache in a temporary directory)."""

from test_torch_runfft_mesh import last_json, run_world


def test_runfft_torch_sharded_crosscheck(tmp_path):
    out = run_world(["-N", "16", "-a", "torch", "-r", "1"], tmp_path)
    assert out.returncode == 0, out.stderr[-1500:]
    rec = last_json(out)
    assert rec["torch_fn"] == "fftn@mesh" and rec["gflops"] > 0


def test_runfft_tune_smoke(tmp_path):
    out = run_world(["-N", "16", "-a", "offt", "--tune", "-l", "4", "-r",
                     "1"], tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr[-1500:]
    assert "tuned: best=" in out.stderr
    assert last_json(out)["t_ms"] > 0
