"""chip_smoke.py's [ddp] model-axis leg alone, on one card: the flagship's
one-process reference (f32, MP_BATCH, MP_STEPS), then two gloo ranks on the
card that run model_axis_rank (a (1, 2) grid), then model_axis_gates, which
logs `[ddp_model_axis]`. About a minute on an H100:

    python3 scripts/probe_torch_model_axis.py
"""
import os, sys, pickle, tempfile, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch
import chip_smoke as cs


def tf32_off():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def rank_main():
    import argparse
    p = argparse.ArgumentParser(); p.add_argument("job"); p.add_argument("--rank", type=int)
    p.add_argument("--world", type=int); p.add_argument("--init-method")
    a = p.parse_args(sys.argv[2:])
    torch.cuda.set_device(0); tf32_off()
    cs.mh.maybe_init_distributed(backend="gloo", init_method=a.init_method, world_size=a.world,
                                 rank=a.rank)
    job = pickle.load(open(a.job, "rb"))
    cfg = cs.merged_config(cs.FLAGSHIP); cfg.PARALLEL.DTYPE = "float32"
    sd = torch.load(job["init_path"], weights_only=True)
    out = {"model_axis": cs.model_axis_rank(job, cfg, sd, a.rank)}
    torch.distributed.destroy_process_group()
    pickle.dump(out, open(f"{a.job}.rank{a.rank}.pkl", "wb"))


if __name__ == "__main__" and sys.argv[1:2] == ["rank"]:
    rank_main()
    sys.exit(0)

tf32_off()
d = tempfile.mkdtemp()
cfg = cs.merged_config(cs.FLAGSHIP); cfg.PARALLEL.DTYPE = "float32"
sd = cs.init_weights(cs.build_model(cfg, device="cpu"), torch.Generator().manual_seed(0)).state_dict()
job = {"init_path": f"{d}/init.pt", "mp_seeds": [350, 351, 352], "mp_ref_path": f"{d}/mp_ref.pt",
       "mp_ckpt": f"{d}/mp_ckpt"}
torch.save(sd, job["init_path"]); pickle.dump(job, open(f"{d}/job.pkl", "wb"))
t0 = time.time()
one_mp = cs.train_steps(cfg, sd, [cs.train_batch(cfg, cs.MP_BATCH, seed=s) for s in job["mp_seeds"]],
                        device="cuda", keep_steps=True)
torch.save(one_mp["grads"][0], job["mp_ref_path"])
one_mp.update(bytes=cs.state_bytes(one_mp["model"], one_mp["optimizer"]),
              opt_shapes={i: {n: tuple(v.shape) for n, v in st.items()}
                          for i, st in one_mp["optimizer"].state_dict()["state"].items()})
for k in ("grads", "states", "model", "optimizer"):
    del one_mp[k]
torch.cuda.empty_cache()
print("one process", time.time() - t0, flush=True)
t1 = time.time()
cs.launch([sys.executable, __file__, "rank", f"{d}/job.pkl"], 2, timeout_s=500)
print("ranks", time.time() - t1, flush=True)
ranks = [pickle.load(open(f"{d}/job.pkl.rank{r}.pkl", "rb")) for r in range(2)]
cs.model_axis_gates(ranks, one_mp, job, torch.cuda.get_device_name(0))
print("probe ok", time.time() - t0)
