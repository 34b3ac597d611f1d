"""The cross-entropy-method stress test (nerfsafetyvalidation_tpu/
validation/stresstests/cross_entropy.py; reference validation/stresstests/
CrossEntropyMethod.py): a population CEM over per-step 12-D normals. Each
iteration samples m trajectories from the proposal q (:79-82); a
trajectory's risk is its least (reward-adjusted) SDF value (:166); the
m_elite least risky, importance-weighted by p / q with log-sum-exp
normalised weights, give the new means and the clamped diagonal
covariances (:211-262); a proposal that cannot be built ends the run
(:264-274); the final proposal's best solution is probed (:303). The
27-column CSV rows of :173-189; `TOY_PROBLEM` takes each trajectory's last
value and the elites from the top (:75-77, :200-206).

The draws are the proposal's (validation/distributions.py): `normals(k,
simulationNumber)` -> [steps, 12] standard normals and `best_normals`
[steps, 12] replace them, so that a test can hand in the JAX package's."""

import csv
import os

import numpy as np
from scipy.special import logsumexp

from ..distributions import SeedableMultivariateNormal
from ..utils.blender import runBlenderOnFailure
from ..utils.math import is_positive_definite


def _weighted_mean_cov(samples, weights):
    """torch.cov(samples.T, aweights=w) and the weighted mean, float64.
    samples: [M, D]; weights: [M]. The normalisation w.sum() - (w^2).sum()
    / w.sum() is floored at 1e-12, so one elite holding all the weight
    gives a covariance of ~0 instead of NaN."""
    w = np.asarray(weights, dtype=np.float64)
    x = np.asarray(samples, dtype=np.float64)
    wsum = w.sum()
    mean = (w[:, None] * x).sum(0) / wsum
    diff = x - mean
    denom = max(wsum - (w ** 2).sum() / wsum, 1e-12)
    return mean, (w[:, None] * diff).T @ diff / denom


def _np(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else \
        np.asarray(x)


class CrossEntropyMethod:
    def __init__(self, simulator, q, p, m, m_elite, kmax, noise_seed,
                 blend_file, workspace, start_iter=0, start_k=0,
                 normals=None, best_normals=None):
        self.steps = len(q.means)
        self.simulator = simulator
        self.q = q
        self.p = p
        self.m = m
        self.m_elite = m_elite
        self.kmax = kmax
        self.means = [0] * self.steps
        self.covs = [0] * self.steps
        self.collisions = 0
        self.stepsToCollision = 0
        self.blend_file = blend_file
        self.workspace = workspace
        self.noise_seed = noise_seed
        self.start_iter = start_iter
        self.start_k = start_k
        self.TOY_PROBLEM = False
        self.plot = False  # seaborn/matplotlib artifacts (CEM.py:255-292)
        self.normals = normals
        self.best_normals = best_normals

    def optimize(self):
        """CrossEntropyMethod.py:49-305. Returns (means, covs, the last
        proposal, the best solution's mean, covariance and value)."""
        populationScores = []
        eliteScores = []
        is_nerf = hasattr(self.simulator, "uq_method")

        for k in range(self.start_k, self.kmax):
            print(f"Starting population {k}")
            population = []
            risks = np.array([])
            self.collisions = 0
            self.stepsToCollision = 0

            for simulationNumber in range(self.start_iter, self.m):
                self.simulator.reset()
                z = None if self.normals is None else \
                    self.normals(k, simulationNumber)
                noises = self.q.sample(simulationNumber, z=z)
                trajectory = [_np(n) for n in noises]
                outputSimulationList = []
                pCumulative = 0.0
                qCumulative = 0.0
                reward = 0.0
                riskSteps = np.array([])
                everCollided = False

                for stepNumber in range(self.steps):
                    outputStepList = [k, simulationNumber, stepNumber]
                    result = self.simulator.step(noises[stepNumber])
                    if is_nerf:
                        (isCollision, collisionVal, currentPos, sigma_d_opt,
                         trace) = result
                    else:
                        isCollision, collisionVal, currentPos = result

                    outputStepList.extend(trajectory[stepNumber])

                    if is_nerf:
                        # the reward-scaled risk (CEM.py:110-122)
                        outputStepList.append(reward)
                        outputStepList.append(sigma_d_opt)
                        curLogLikelihood = self.p.distributions[
                            stepNumber].log_prob(noises[stepNumber])
                        reward = self.simulator.reward(
                            float(curLogLikelihood), sigma_d_opt, trace)
                        risk = collisionVal
                        scaled_reward = reward * (0.01 * risk)
                        collisionVal = risk - scaled_reward

                    outputStepList.append(collisionVal)
                    outputStepList.extend(np.asarray(currentPos))

                    pStep = self.p.distributions[stepNumber].log_prob(
                        noises[stepNumber])
                    qStep = self.q.distributions[stepNumber].log_prob(
                        noises[stepNumber])
                    pCumulative += float(pStep)
                    qCumulative += float(qStep)
                    outputStepList.append(float(pStep))
                    outputStepList.append(float(qStep))
                    outputStepList.append(pCumulative)
                    outputStepList.append(qCumulative)
                    outputSimulationList.append(outputStepList)
                    outputStepList.append(bool(isCollision))

                    riskSteps = np.append(riskSteps, collisionVal)

                    if isCollision:
                        self.collisions += 1
                        self.stepsToCollision += stepNumber
                        everCollided = True
                        if not self.TOY_PROBLEM:
                            runBlenderOnFailure(self.blend_file,
                                                self.workspace,
                                                simulationNumber, stepNumber,
                                                outputSimulationList,
                                                populationNum=k)
                        break

                population.append(trajectory)
                if self.TOY_PROBLEM:
                    risks = np.append(risks, riskSteps[-1])
                else:
                    risks = np.append(risks, min(riskSteps))

                if everCollided:
                    print(f"Percentage of collisions: "
                          f"{self.collisions / (simulationNumber + 1) * 100}%")
                    print(f"Average number of steps to collision: "
                          f"{self.stepsToCollision / self.collisions}")

                if not self.TOY_PROBLEM:
                    os.makedirs("./results", exist_ok=True)
                    # the 27-column schema of CEM.py:173-189
                    with open(f"./results/collisionValuesCEM_m{self.m}"
                              f"melite{self.m_elite}k{self.kmax}.csv",
                              "a") as csvFile:
                        writer = csv.writer(csvFile)
                        for outputStepList in outputSimulationList:
                            outputStepList.append(everCollided)
                            writer.writerow(outputStepList)

            print(f"Average score of population {k}: {risks.mean()}")
            populationScores.append(risks.mean())

            # the elites (CEM.py:211-216)
            if self.TOY_PROBLEM:
                elite_indices = np.argsort(risks)[-self.m_elite:]
            else:
                elite_indices = np.argsort(risks)[:self.m_elite]
            elite_samples = np.asarray(population)[elite_indices]  # [E, T, 12]
            eliteScores.append(risks[elite_indices].mean())
            print(f"Average score of elite samples from population {k}: "
                  f"{risks[elite_indices].mean()}")

            for i in range(self.steps):
                log_w = np.asarray([
                    float(self.p.distributions[i].log_prob(e)
                          - self.q.distributions[i].log_prob(e))
                    for e in elite_samples[:, i]])
                log_w = log_w - logsumexp(log_w)
                weights = np.exp(log_w)
                if np.any(weights <= 0):
                    print(f"Warning: Negative/zero weights detected: "
                          f"{weights}")
                    weights = np.clip(weights, 1e-8, None)

                mean, cov = _weighted_mean_cov(elite_samples[:, i], weights)
                diag = np.diag(cov).copy()
                if (diag > 0.1).any() or (diag < 0).any():
                    print(f"Step {i} in population {k} has a covariance "
                          "diagonal that is too large or negative! Clamping "
                          "between 0 and 0.1...")
                    diag = np.clip(diag, 0, 0.1)
                cov = np.diag(diag)
                self.means[i] = mean.astype(np.float32)
                self.covs[i] = cov.astype(np.float32)
                print("Covariance matrix is positive definite: "
                      + str(is_positive_definite(self.covs[i])))
                if self.plot:
                    self._plot_noise_histogram(population, i)

            try:
                self.q = SeedableMultivariateNormal(
                    self.means, self.covs, self.noise_seed,
                    device=self.p.device)
            except Exception:
                print(f"Highly improbable weights in population {k}! "
                      "Exiting...")
                break

            print("Updated Proposal Distribution:")
            for i in range(self.steps):
                print(f"Step {i}: Mean: {self.means[i]}, "
                      f"Covariance: {self.covs[i]}")

        if self.plot:
            self._plot_scores(populationScores, eliteScores)

        print("===FINISHED OPTIMIZATION===")
        print("===NOMINAL VALUES===\n")
        for i in range(self.steps):
            print(f"Step {i}: Mean: {self.means[i]}, Covariance: "
                  f"{self.covs[i]}")

        best_mean, best_cov, best_value = self.q.compute_best_solution(
            self.simulator, z=self.best_normals)
        return (self.means, self.covs, self.q, best_mean, best_cov,
                best_value)

    def _plot_noise_histogram(self, population, step):
        """The step's noise vectors' distribution (CEM.py:255-262)."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        try:
            import seaborn as sns
        except ImportError:
            sns = None
        os.makedirs("./results/pltpaths", exist_ok=True)
        plt.figure()
        for sample in population:
            if sns is not None:
                sns.histplot(np.asarray(sample[step]), kde=True, bins=30)
            else:
                plt.hist(np.asarray(sample[step]), bins=30, alpha=0.5)
        plt.title(f"Distribution of noise vectors at step {step}")
        plt.xlabel("Noise")
        plt.ylabel("Density")
        plt.savefig(f"./results/pltpaths/noise_distribution_step_{step}.png")
        plt.close()

    def _plot_scores(self, populationScores, eliteScores):
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        os.makedirs("./results/pltpaths", exist_ok=True)
        plt.figure()
        plt.plot(populationScores)
        plt.plot(eliteScores)
        plt.legend(["Population", "Elite"])
        plt.xlabel("Population #")
        plt.ylabel("Average Score")
        plt.savefig("./results/pltpaths/populationScores.png")
        plt.close()
