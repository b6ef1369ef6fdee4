"""L3 positives: watched artifacts written without the atomic protocol."""
import json


def save_manifest(meta):
    with open("ckpt_manifest.json", "w") as f:  # line 6: direct write
        json.dump(meta, f)


def save_best(out_dir, obj):
    best = out_dir + "/best.json"
    with open(best, "w") as f:  # line 12: one-hop assigned watched path
        json.dump(obj, f)


def save_weights(blob):
    f = open("model.ckpt.msgpack", "wb")  # line 17: bare write handle
    f.write(blob)
    f.close()
