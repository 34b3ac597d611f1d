"""The Monte-Carlo stress test (nerfsafetyvalidation_tpu/validation/
stresstests/monte_carlo.py; reference validation/stresstests/
MonteCarlo.py): n_simulations rollouts of `steps` disturbances with the
reward-adapted noise std (std + 0.01 std reward, :49-52), the per-step
Gaussian log-likelihood (:29-35), the CSV rows of the reference's schema
(:95-116), the Blender failure visualization on a collision (:88-93), and
`start_iter` to resume.

The JAX package splits one threefry key a step, the key running on across
the simulations. The port draws from one torch.Generator on the device,
seeded noise_seed, in the same order; `normals` (an iterable of [12]
standard normals, one a step in that order) replaces the draws, so that a
test can hand in the JAX package's."""

import csv
import os

import numpy as np
import torch
from scipy.stats import norm

from ..utils.blender import runBlenderOnFailure


class MonteCarlo:
    collisions = 0
    stepsToCollision = 0

    def __init__(self, simulator, n_simulations, steps, noise_mean, noise_std,
                 blend_file, workspace, start_iter, noise_seed: int = 0,
                 device="cpu", normals=None):
        self.simulator = simulator
        self.n_simulations = n_simulations
        self.device = dev = torch.device(device)
        self.noise_mean = torch.as_tensor(np.asarray(noise_mean, np.float32),
                                          device=dev)
        self.noise_std = torch.as_tensor(np.asarray(noise_std, np.float32),
                                         device=dev)
        self.noise_mean_cpu = np.asarray(noise_mean, dtype=np.float32)
        self.noise_std_cpu = np.asarray(noise_std, dtype=np.float32)
        self.steps = steps
        self.blend_file = blend_file
        self.workspace = workspace
        self.start_iter = start_iter
        self.generator = torch.Generator(device=dev).manual_seed(
            int(noise_seed))
        self.normals = None if normals is None else iter(normals)

    def trajectoryLikelihood(self, noise):
        """The sum of the elements' log N(noise; mean, std), each density
        clipped to [1e-8, 1e8] (MonteCarlo.py:29-35)."""
        lik = norm.pdf(np.asarray(noise), loc=self.noise_mean_cpu,
                       scale=self.noise_std_cpu)
        lik = np.clip(lik, 1e-8, 1e8)
        return np.log(lik).sum()

    def _normal(self):
        if self.normals is not None:
            return torch.as_tensor(np.asarray(next(self.normals), np.float32),
                                   device=self.device)
        return torch.randn(self.noise_mean.shape, generator=self.generator,
                           device=self.device)

    def validate(self):
        """MonteCarlo.py:37-121: the sequential loop; a simulation's rows
        are appended to results/collisionValuesBlenderMC_n<N>.csv when it
        ends."""
        is_nerf = hasattr(self.simulator, "uq_method")
        for simulationNumber in range(self.start_iter, self.n_simulations):
            self.simulator.reset()
            outputSimulationList = []
            everCollided = False
            simTrajLogLikelihood = 0.0
            reward = 0.0
            noise_std = self.noise_std

            print(f"Starting simulation {simulationNumber}")
            for stepNumber in range(self.steps):
                # the reward-adapted noise std (MonteCarlo.py:49-52)
                adjusted_noise_std = noise_std + float(reward) * (
                    0.01 * noise_std)
                noise = self.noise_mean + adjusted_noise_std * self._normal()

                result = self.simulator.step(noise)
                if is_nerf:
                    (isCollision, collisionVal, currentPos, sigma_d_opt,
                     trace) = result
                else:
                    isCollision, collisionVal, currentPos = result

                outputStepList = [simulationNumber, stepNumber]
                noiseList = noise.cpu().numpy()
                outputStepList.extend(noiseList)
                outputStepList.append(collisionVal)
                outputStepList.extend(np.asarray(currentPos))

                curLogLikelihood = self.trajectoryLikelihood(noiseList)
                outputStepList.append(curLogLikelihood)
                simTrajLogLikelihood += curLogLikelihood
                outputStepList.append(simTrajLogLikelihood)

                if is_nerf:
                    outputStepList.append(reward)
                    outputStepList.append(sigma_d_opt)
                    reward = self.simulator.reward(curLogLikelihood,
                                                   sigma_d_opt, trace)

                outputStepList.append(isCollision)
                outputSimulationList.append(outputStepList)

                if isCollision:
                    self.collisions += 1
                    self.stepsToCollision += stepNumber
                    everCollided = True
                    runBlenderOnFailure(self.blend_file, self.workspace,
                                        simulationNumber, stepNumber,
                                        outputSimulationList)
                    break

            os.makedirs("./results", exist_ok=True)
            # the CSV schema of MonteCarlo.py:95-110
            with open(f"./results/collisionValuesBlenderMC_"
                      f"n{self.n_simulations}.csv", "a") as csvFile:
                writer = csv.writer(csvFile)
                for outputStepList in outputSimulationList:
                    outputStepList.append(everCollided)
                    writer.writerow(outputStepList)

        if self.collisions > 0:
            print(f"\n\t{self.collisions} collisions in "
                  f"{self.n_simulations} simulations, for a crash % of "
                  f"{100 * self.collisions / self.n_simulations}%\n")
            print(f"\tAverage step at collision: "
                  f"{self.stepsToCollision / self.collisions}\n")
