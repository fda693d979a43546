"""The recommender of Paddle's book (Fluid 1.3 book chapter
"recommender_system", ``tests/book/test_recommender_system.py``; the
repo's copy is ``tests/book/test_recommender_system.py``), written against
a ``fluid`` module given as an argument, so the port and the JAX package
build the same programs from one definition:

- :func:`usr_tower`: user id, gender, age and job embedded, an fc each,
  concatenated, then an fc to the tower width with tanh;
- :func:`mov_tower`: movie id embedded and an fc; its categories (lod 1)
  embedded and sum-pooled; its title (lod 1) embedded and through
  ``nets.sequence_conv_pool`` (a window-3 ``sequence_conv`` with tanh,
  sum-pooled); concatenated, then an fc to the tower width with tanh;
- :func:`train_net`: ``cos_sim`` of the towers scaled by 5 (the rating
  scale), the mean square error against the score, SGD;
- :func:`train_batch`: a synthetic MovieLens batch of the test's kind.

``BOOK`` holds the published sizes (Fluid 1.3 book,
05.recommender_system/train.py over paddle.dataset.movielens, ml-1m):
6041 user ids, 2 genders, 7 age groups, 21 jobs, 3953 movie ids, 18
categories, a title dictionary of 5175 words; embeddings 32 (16 for
gender, age and job), 32 title filters of width 3, towers 200 wide, SGD
0.2, batch 256.  ``TEST`` holds the repo test's cut (users 50, movies
100, 10 categories, 60 title words, embeddings 16 and 8, 16 filters,
towers 32, SGD 0.05).
"""

import numpy as np

BOOK = dict(users=6041, genders=2, ages=7, jobs=21, movies=3953,
            categories=18, title_dict=5175, emb=32, small_emb=16,
            filters=32, tower=200)
BOOK_BATCH, BOOK_LR = 256, 0.2
TEST = dict(users=50, genders=2, ages=7, jobs=21, movies=100,
            categories=10, title_dict=60, emb=16, small_emb=8, filters=16,
            tower=32)
TEST_LR = 0.05
USR_FEEDS = ["user_id", "gender_id", "age_id", "job_id"]
MOV_FEEDS = ["movie_id", "category_id", "movie_title"]


def _fc(fluid, x, size, name, act=None):
    return fluid.layers.fc(input=x, size=size, act=act,
                           param_attr=fluid.ParamAttr(name=f"{name}_w"),
                           bias_attr=fluid.ParamAttr(name=f"{name}_b"))


def _id_fc(fluid, name, dict_size, width, lod_level=0):
    layers = fluid.layers
    x = layers.data(name=name, shape=[1], dtype="int64",
                    lod_level=lod_level)
    return layers.embedding(
        input=x, size=[dict_size, width], dtype="float32",
        param_attr=fluid.ParamAttr(name=f"{name}_table"))


def usr_tower(fluid, users, genders, ages, jobs, emb, small_emb, tower,
              **_):
    parts = [_fc(fluid, _id_fc(fluid, name, size, width), width,
                 f"{name}_fc")
             for name, size, width in (("user_id", users, emb),
                                       ("gender_id", genders, small_emb),
                                       ("age_id", ages, small_emb),
                                       ("job_id", jobs, small_emb))]
    return _fc(fluid, fluid.layers.concat(input=parts, axis=1), tower,
               "usr_combined", act="tanh")


def mov_tower(fluid, movies, categories, title_dict, emb, filters, tower,
              **_):
    mov_fc = _fc(fluid, _id_fc(fluid, "movie_id", movies, emb), emb,
                 "movie_fc")
    cat_pool = fluid.layers.sequence_pool(
        input=_id_fc(fluid, "category_id", categories, emb, lod_level=1),
        pool_type="sum")
    title_conv = fluid.nets.sequence_conv_pool(
        input=_id_fc(fluid, "movie_title", title_dict, emb, lod_level=1),
        num_filters=filters, filter_size=3, act="tanh", pool_type="sum",
        param_attr=fluid.ParamAttr(name="title_conv_w"),
        bias_attr=fluid.ParamAttr(name="title_conv_b"))
    return _fc(fluid, fluid.layers.concat(
        input=[mov_fc, cat_pool, title_conv], axis=1), tower,
        "mov_combined", act="tanh")


def train_net(fluid, learning_rate, **sizes):
    """The book's training program: returns (avg_cost, scaled score)."""
    layers = fluid.layers
    inference = layers.cos_sim(X=usr_tower(fluid, **sizes),
                               Y=mov_tower(fluid, **sizes))
    scale_infer = layers.scale(x=inference, scale=5.0)
    label = layers.data(name="score", shape=[1], dtype="float32")
    avg_cost = layers.mean(layers.square_error_cost(input=scale_infer,
                                                    label=label))
    fluid.optimizer.SGD(learning_rate=learning_rate).minimize(avg_cost)
    return avg_cost, scale_infer


def train_batch(rng, n, users, genders, ages, jobs, movies, categories,
                title_dict, **_):
    """A synthetic MovieLens batch: ids uniform over each dictionary, 1-3
    categories and a 2-7 word title a movie, and a rating in {1, 5} that
    a user's and a movie's ids determine."""
    feed = {
        "user_id": rng.integers(0, users, (n, 1)),
        "gender_id": rng.integers(0, genders, (n, 1)),
        "age_id": rng.integers(0, ages, (n, 1)),
        "job_id": rng.integers(0, jobs, (n, 1)),
        "movie_id": rng.integers(0, movies, (n, 1)),
        "category_id": [rng.integers(0, categories,
                                     (int(rng.integers(1, 4)), 1))
                        for _ in range(n)],
        "movie_title": [rng.integers(0, title_dict,
                                     (int(rng.integers(2, 8)), 1))
                        for _ in range(n)],
    }
    like = feed["user_id"][:, 0] % 5 == feed["movie_id"][:, 0] % 5
    feed["score"] = np.where(like, 5.0, 1.0).astype(np.float32)[:, None]
    return feed
