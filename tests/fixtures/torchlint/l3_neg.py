"""L3 negatives: the atomic protocol, sanctioned writers, unwatched paths."""
import json
import os


def publish_atomic(ckpt_path, obj):
    tmp = ckpt_path + ".tmp"
    with open(tmp, "w") as f:  # clean: tmp is os.replace'd below
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, ckpt_path)


def write_json_atomic(path, obj):
    # the sanctioned writer itself (its open IS the protocol's tmp half)
    with open(path + ".ckpt.tmp", "w") as f:
        json.dump(obj, f)


def save_log(row):
    with open("results/decode_log.jsonl", "a") as f:  # clean: not watched
        f.write(row)


def read_manifest(path):
    with open("ckpt_manifest.json") as f:  # clean: read, not write
        return json.load(f)
