"""Rossmann-style store-sales regression: Spark ETL + distributed Keras.

Counterpart of the reference's ``examples/keras_spark_rossmann.py``: Spark
owns the tabular feature engineering, then
``horovod_tpu_torch.spark.run`` trains an entity-embedding MLP on every
executor as one rank. The reference's
Kaggle CSVs are not shippable; an equivalent synthetic store-sales table is
generated instead, with the same shape of pipeline:

1. ETL: categorical columns indexed, continuous columns scaled, target
   log-transformed (the reference's ``log(Sales)`` + ``exp_rmspe`` recipe).
2. Train: per-category embeddings concatenated with continuous features,
   two dense layers, rank-0 checkpoint, metric averaging across ranks.

The port's counterpart of ``examples/keras_spark_rossmann.py``: the same
synthetic table, flags and printed lines, over ``horovod_tpu_torch.keras``
and ``horovod_tpu_torch.spark``. Needs a local pyspark for the Spark path:

    python -m horovod_tpu_torch.examples.keras_spark_rossmann --num-proc 2

Without pyspark the ETL falls back to plain numpy in-process (same
features, no cluster), so the model/feature code is importable and testable
anywhere; without tensorflow ``main`` raises the Keras front end's message
before any work.
"""

import argparse

import numpy as np

CATEGORICAL = {"store": 200, "day_of_week": 7, "promo": 2, "state_holiday": 4,
               "month": 12}
CONTINUOUS = ["competition_distance", "days_since_promo2"]


def synthetic_rossmann(n=8192, seed=0):
    """Store-sales rows with a learnable structure: sales driven by store
    identity, weekday, promos and competition distance."""
    rng = np.random.RandomState(seed)
    rows = {
        "store": rng.randint(0, CATEGORICAL["store"], n),
        "day_of_week": rng.randint(0, 7, n),
        "promo": rng.randint(0, 2, n),
        "state_holiday": rng.randint(0, 4, n),
        "month": rng.randint(0, 12, n),
        "competition_distance": rng.lognormal(7.0, 1.0, n),
        "days_since_promo2": rng.randint(0, 365, n).astype(np.float64),
    }
    store_effect = rng.rand(CATEGORICAL["store"]) * 2 + 1
    dow_effect = np.array([1.0, 1.0, 0.95, 0.9, 1.0, 1.3, 0.2])
    sales = (3000.0 * store_effect[rows["store"]]
             * dow_effect[rows["day_of_week"]]
             * (1.0 + 0.35 * rows["promo"])
             * np.exp(-rows["competition_distance"] / 3e4)
             * np.exp(rng.randn(n) * 0.1))
    rows["sales"] = sales * (rows["state_holiday"] == 0)
    return rows


def engineer_features(rows):
    """The reference's prep: drop closed/zero-sales days, scale continuous
    columns, log-transform the target (train on log(Sales), score RMSPE in
    linear space)."""
    mask = rows["sales"] > 0
    cats = np.stack([rows[c][mask] for c in CATEGORICAL], axis=1)
    conts = np.stack(
        [rows[c][mask].astype(np.float32) for c in CONTINUOUS], axis=1)
    conts = (conts - conts.mean(axis=0)) / (conts.std(axis=0) + 1e-8)
    log_sales = np.log(rows["sales"][mask]).astype(np.float32)
    max_log = float(log_sales.max())
    return cats.astype(np.int32), conts.astype(np.float32), \
        log_sales / max_log, max_log


def build_model(embed_dim=10):
    import tensorflow as tf
    cat_in = tf.keras.Input(shape=(len(CATEGORICAL),), dtype="int32")
    cont_in = tf.keras.Input(shape=(len(CONTINUOUS),), dtype="float32")
    embeds = []
    for i, name in enumerate(CATEGORICAL):
        card = CATEGORICAL[name]
        e = tf.keras.layers.Embedding(card, min(embed_dim, (card + 1) // 2),
                                      name=f"embed_{name}")(cat_in[:, i])
        embeds.append(tf.keras.layers.Flatten()(e))
    h = tf.keras.layers.Concatenate()(embeds + [cont_in])
    h = tf.keras.layers.Dense(128, activation="relu")(h)
    h = tf.keras.layers.Dense(64, activation="relu")(h)
    out = tf.keras.layers.Dense(1, activation="sigmoid")(h)
    return tf.keras.Model([cat_in, cont_in], out)


def exp_rmspe(max_log):
    """RMSPE in linear sales space, as the reference's ``exp_rmspe``."""
    import tensorflow as tf

    def metric(y_true, y_pred):
        true = tf.exp(y_true * max_log)
        pred = tf.exp(y_pred * max_log)
        pct = (true - pred) / true
        return tf.sqrt(tf.reduce_mean(tf.square(pct)))

    metric.__name__ = "exp_rmspe"
    return metric


def train_fn(cats, conts, target, max_log, epochs, batch_size, lr):
    """Runs on each executor as one rank (or in-process without Spark)."""
    import tensorflow as tf

    import horovod_tpu_torch.keras as hvd

    hvd.init()
    cats = cats[hvd.rank()::hvd.size()]
    conts = conts[hvd.rank()::hvd.size()]
    target = target[hvd.rank()::hvd.size()]

    model = build_model()
    opt = hvd.DistributedOptimizer(tf.keras.optimizers.Adam(lr * hvd.size()))
    model.compile(optimizer=opt, loss="mae", metrics=[exp_rmspe(max_log)])

    callbacks = [
        hvd.callbacks.BroadcastGlobalVariablesCallback(0),
        hvd.callbacks.MetricAverageCallback(),
    ]
    hist = model.fit([cats, conts], target, batch_size=batch_size,
                     epochs=epochs, callbacks=callbacks,
                     verbose=2 if hvd.rank() == 0 else 0)
    return hvd.rank(), float(hist.history["exp_rmspe"][-1])


def main(argv=None):
    # The front end first: without tensorflow its import raises the
    # message.
    import horovod_tpu_torch.keras  # noqa: F401

    parser = argparse.ArgumentParser()
    parser.add_argument("--num-proc", type=int, default=2)
    parser.add_argument("--epochs", type=int, default=4)
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--rows", type=int, default=8192)
    args = parser.parse_args(argv)

    try:
        from pyspark.sql import SparkSession
        have_spark = True
    except ImportError:
        have_spark = False

    rows = synthetic_rossmann(args.rows)

    if have_spark:
        # Spark-side ETL (the reference pipeline's shape): filter closed
        # days, z-scale continuous columns and log-normalise the target as
        # DataFrame transforms, and only collect the finished feature
        # columns.
        spark = SparkSession.builder.master(
            f"local[{args.num_proc}]").appName("rossmann").getOrCreate()
        import pyspark.sql.functions as F
        df = spark.createDataFrame(
            list(zip(*[rows[k].tolist() for k in rows])), list(rows))
        df = df.filter(F.col("sales") > 0)
        stats = df.agg(*[F.mean(c).alias(f"{c}_mean") for c in CONTINUOUS],
                       *[F.stddev(c).alias(f"{c}_std") for c in CONTINUOUS],
                       F.max(F.log("sales")).alias("max_log")).first()
        for c in CONTINUOUS:
            df = df.withColumn(c, (F.col(c) - stats[f"{c}_mean"])
                               / (stats[f"{c}_std"] + 1e-8))
        max_log = float(stats["max_log"])
        df = df.withColumn("target", F.log("sales") / max_log)
        pdf = df.toPandas()
        cats = np.stack([pdf[c].to_numpy() for c in CATEGORICAL],
                        axis=1).astype(np.int32)
        conts = np.stack([pdf[c].to_numpy() for c in CONTINUOUS],
                         axis=1).astype(np.float32)
        target = pdf["target"].to_numpy().astype(np.float32)

        import horovod_tpu_torch.spark as hvd_spark
        results = hvd_spark.run(
            train_fn, args=(cats, conts, target, max_log, args.epochs,
                            args.batch_size, args.lr),
            num_proc=args.num_proc)
        spark.stop()
    else:
        print("pyspark not installed - running the same pipeline "
              "in-process at size 1")
        cats, conts, target, max_log = engineer_features(rows)
        results = [train_fn(cats, conts, target, max_log, args.epochs,
                            args.batch_size, args.lr)]

    for rank, rmspe in sorted(results):
        print(f"rank {rank}: final exp_rmspe={rmspe:.4f}")


if __name__ == "__main__":
    main()
