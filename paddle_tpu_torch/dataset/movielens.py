"""MovieLens ml-1m reader (reference: python/paddle/dataset/movielens.py).

Synthetic offline, with the real ml-1m cardinalities (3952 movies, 6040
users, 21 jobs, 18 genres, the reference's 7-bucket age table) and the
same record contract::

    (user_id, gender_id, age_id, job_id,
     movie_id, [category_ids], [title_ids], score)

Ratings are a LOW-RANK function of fixed per-user/per-movie latent
vectors (score = clip(round(3 + u.v), 1, 5)), so factorization
recommenders (book ch5) genuinely learn from it.
"""

from __future__ import annotations

import numpy as np

age_table = [1, 18, 25, 35, 45, 50, 56]

_MAX_USER = 6040
_MAX_MOVIE = 3952
_MAX_JOB = 20
_N_CATEGORIES = 18
_TITLE_VOCAB = 5175
_LATENT_K = 6


class MovieInfo:
    """Movie id, title word ids and category ids
    (reference: movielens.py:49 — here ids directly, no raw strings)."""

    def __init__(self, index, categories, title):
        self.index = int(index)
        self.categories = list(categories)
        self.title = list(title)

    def value(self):
        return [self.index, self.categories, self.title]


class UserInfo:
    """User id, gender, bucketed age, job (reference: movielens.py:74)."""

    def __init__(self, index, gender_id, age_id, job_id):
        self.index = int(index)
        self.is_male = gender_id == 0
        self.age = int(age_id)
        self.job_id = int(job_id)

    def value(self):
        return [self.index, 0 if self.is_male else 1, self.age, self.job_id]


def _latents():
    r = np.random.RandomState(41)
    u = r.normal(0, 0.6, (_MAX_USER + 1, _LATENT_K))
    m = r.normal(0, 0.6, (_MAX_MOVIE + 1, _LATENT_K))
    return u, m


def _movie_meta():
    r = np.random.RandomState(42)
    cats = [sorted(set(r.randint(0, _N_CATEGORIES,
                                 1 + int(r.randint(3))).tolist()))
            for _ in range(_MAX_MOVIE + 1)]
    titles = [r.randint(3, _TITLE_VOCAB, 2 + int(r.randint(4))).tolist()
              for _ in range(_MAX_MOVIE + 1)]
    return cats, titles


def _user_meta():
    """(genders, ages, jobs) arrays indexed by user id — the single
    source for demographics, shared by the reader and user_info()."""
    meta = np.random.RandomState(43)
    genders = meta.randint(0, 2, _MAX_USER + 1)
    ages = meta.randint(0, len(age_table), _MAX_USER + 1)
    jobs = meta.randint(0, _MAX_JOB + 1, _MAX_USER + 1)
    return genders, ages, jobs


def _reader(n, seed):
    def reader():
        u_lat, m_lat = _latents()
        cats, titles = _movie_meta()
        r = np.random.RandomState(seed)
        genders, ages, jobs = _user_meta()
        for _ in range(n):
            u = int(r.randint(1, _MAX_USER + 1))
            m = int(r.randint(1, _MAX_MOVIE + 1))
            score = float(np.clip(
                np.round(3.0 + u_lat[u] @ m_lat[m]), 1, 5))
            yield [u, int(genders[u]), int(ages[u]), int(jobs[u]),
                   m, cats[m], titles[m], score]

    return reader


def train(rand_seed=0):
    return _reader(16384, 51 + rand_seed)


def test(rand_seed=0):
    return _reader(2048, 52 + rand_seed)


def max_user_id():
    return _MAX_USER


def max_movie_id():
    return _MAX_MOVIE


def max_job_id():
    return _MAX_JOB


def movie_categories():
    return {f"genre{i}": i for i in range(_N_CATEGORIES)}


def get_movie_title_dict():
    return {f"t{i}": i for i in range(_TITLE_VOCAB)}


def user_info():
    genders, ages, jobs = _user_meta()
    return {i: UserInfo(i, int(genders[i]), int(ages[i]), int(jobs[i]))
            for i in range(1, _MAX_USER + 1)}


def movie_info():
    cats, titles = _movie_meta()
    return {i: MovieInfo(i, cats[i], titles[i])
            for i in range(1, _MAX_MOVIE + 1)}
